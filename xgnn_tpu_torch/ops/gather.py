"""K1: the row gather, ``out[i, :] = feat[ids[i], :]``.

The port of ``xgnn_tpu/ops/pallas_gather.py`` (``gather_rows_pallas``, the
JAX package's one Pallas kernel).  An id that is EMPTY, negative or past the
table gives a zero row.  The JAX main path computes the same function with
``jnp.take`` in ``models/gnn._take_dst`` and ``store/feature_store
._gather_rows``; in the port both go through this kernel.

The CUDA kernel is ``csrc/gather.cu``.  :func:`gather_rows_plain` is its
plain PyTorch version: the wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import _build

# launches are counted by the table's type: the 2-byte forms apart
_NAMES = {torch.bfloat16: "gather_rows_bf16",
          torch.float16: "gather_rows_f16"}
_NAME = "gather_rows"
# the tables the kernel copies, by their element's bytes
DTYPES = {torch.float32: 4, torch.int32: 4, torch.bfloat16: 2,
          torch.float16: 2}


def gather_rows_plain(feat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    valid = (ids >= 0) & (ids < feat.shape[0])
    rows = feat[torch.where(valid, ids, 0)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=feat.dtype,
                                                          device=feat.device))


def _check(feat: torch.Tensor, ids: torch.Tensor):
    if feat.dim() != 2 or feat.dtype not in DTYPES:
        raise ValueError(
            f"gather_rows: feat must be 2-D float32, int32, bfloat16 or "
            f"float16, got "
            f"{feat.dtype} {tuple(feat.shape)}"
        )
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"gather_rows: ids must be 1-D int32, got {ids.dtype} "
            f"{tuple(ids.shape)}"
        )
    if feat.device != ids.device:
        raise ValueError(
            f"gather_rows: feat on {feat.device}, ids on {ids.device}"
        )
    if not (feat.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_rows: feat and ids must be contiguous")
    if feat.requires_grad:
        # its inputs on the main path (the feature table, the labels) need
        # no gradient; a backward is ROADMAP K1-backward
        raise NotImplementedError(
            "gather_rows has no backward yet (ROADMAP K1 backward)"
        )


def gather_rows(feat: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``(B,)`` int32 ids into a ``(N, F)`` float32, int32, bfloat16 or
    float16 table give ``(B, F)`` rows of the table's dtype."""
    _check(feat, ids)
    if feat.device.type == "cpu":
        return gather_rows_plain(feat, ids)
    if feat.device.type != "cuda":
        raise ValueError(f"gather_rows: no kernel for {feat.device}")
    lib = _build.load("gather")
    out = torch.empty((ids.shape[0], feat.shape[1]), dtype=feat.dtype,
                      device=feat.device)
    if ids.shape[0] and feat.shape[1]:
        rc = lib.xg_gather_rows(
            feat.data_ptr(), ids.data_ptr(), out.data_ptr(),
            feat.shape[0], ids.shape[0], feat.shape[1], DTYPES[feat.dtype],
            _build.stream_handle(feat.device),
        )
        name = _NAMES.get(feat.dtype, _NAME)
        _build.check(rc, name)
        _build.LAUNCHES.add(name)
    return out
