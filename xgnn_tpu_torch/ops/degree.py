"""K7: the multiplicity of each pick's id within a block's pick set.

The port of ``xgnn_tpu/ops/degree.py`` (``pick_multiplicity``), the
block-local out-degree that GCN's symmetric norm needs:
``counts[p] = #{q : ids[q] == ids[p]}`` over the valid picks of the whole
flattened block, not per row, and 0 where a pick is not valid.  A pick is
valid when it lies in ``[0, num_rows)``; EMPTY does not.  The JAX function
counts any id other than EMPTY; ids outside ``[0, num_rows)`` other than
EMPTY are outside the contract (the sampler's ids are rows of the src table
or EMPTY), and here they count 0 (ROADMAP section 3).  Beside the counts
it returns GCN's per-pick weights ``rsqrt(max(counts, 1))`` in float32,
what its one caller, ``GCNConv``, needs.

The CUDA kernel is ``csrc/degree.cu``: a memset of the bins, an
integer-atomic histogram over ``[0, num_rows)``, then a gather of each
pick's bin that also writes the weights: three launches.  The counts are
int32 and exact; the weights are bit-equal to :func:`weights_of` on the
card.  :func:`pick_multiplicity_plain` is its plain PyTorch version, which
the wrapper takes only for tensors on the CPU.  Launches are counted as
``pick_multiplicity``, one per call.
"""

from __future__ import annotations

import torch

from . import _build

_NAME = "pick_multiplicity"


def weights_of(counts: torch.Tensor) -> torch.Tensor:
    """GCN's per-pick weights from the counts, as ``GCNConv`` writes them."""
    return torch.rsqrt(torch.clamp(counts.to(torch.float32), min=1.0))


def pick_multiplicity_plain(ids: torch.Tensor, num_rows: int):
    """``bincount`` of the valid ids, read back at every pick, and the
    weights of those counts."""
    flat = ids.reshape(-1)
    valid = (flat >= 0) & (flat < num_rows)
    safe = torch.where(valid, flat, 0).long()
    hist = torch.bincount(safe[valid], minlength=max(num_rows, 1))
    counts = torch.where(valid, hist[safe], 0).to(torch.int32)
    counts = counts.reshape(ids.shape)
    return counts, weights_of(counts)


def _check(ids: torch.Tensor, num_rows: int):
    if ids.dtype != torch.int32:
        raise ValueError(f"pick_multiplicity: ids must be int32, got "
                         f"{ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("pick_multiplicity: ids must be contiguous")
    if not 0 <= num_rows < 2**31 - 1:
        raise ValueError(f"pick_multiplicity: num_rows {num_rows} outside "
                         "[0, 2^31 - 1)")
    if ids.numel() >= 2**31:
        raise ValueError("pick_multiplicity: 2^31 picks or more")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pick_multiplicity: no kernel for {ids.device}")


def pick_multiplicity(ids: torch.Tensor, num_rows: int):
    """``(counts, weights)`` of ``ids``' shape: the int32 count of how
    often each valid pick's id occurs among all the valid picks, 0 for a
    pick outside ``[0, num_rows)``, and the float32
    ``rsqrt(max(counts, 1))``."""
    _check(ids, num_rows)
    if ids.device.type == "cpu":
        return pick_multiplicity_plain(ids, num_rows)
    lib = _build.load("degree")
    counts = torch.empty_like(ids)
    w = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if ids.numel():
        hist = torch.empty((max(num_rows, 1),), dtype=torch.int32,
                           device=ids.device)
        rc = lib.xg_pick_multiplicity(
            ids.data_ptr(), counts.data_ptr(), w.data_ptr(), hist.data_ptr(),
            ids.numel(), num_rows, _build.stream_handle(ids.device),
        )
        _build.check(rc, _NAME)
        _build.LAUNCHES.add(_NAME)
    return counts, w
