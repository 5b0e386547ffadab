"""The port's CUDA kernels and its pipelined engine on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one.  The machine with the card has no JAX, so run this file
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EMPTY = int(np.iinfo(np.int32).max)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("width", [1, 3, 4, 128, 131, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_rows_kernel_equals_plain(dev, width, dtype):
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    g = _gen(dev, width)
    n = 3000
    if dtype == torch.float32:
        feat = torch.randn((n, width), generator=g, device=dev)
    else:
        feat = torch.randint(-9, 9, (n, width), generator=g, device=dev,
                             dtype=torch.int32)
    ids = torch.randint(-5, n + 5, (4099,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::3] = EMPTY
    out = gather_rows(feat, ids)
    assert torch.equal(out, gather_rows_plain(feat, ids))
    # an unaligned view takes the 4-byte path
    sub = feat[1:]
    assert torch.equal(gather_rows(sub, ids), gather_rows_plain(sub, ids))
    assert gather_rows(feat, ids[:0]).shape == (0, width)


@pytest.mark.parametrize("width,fanout", [(128, 5), (256, 10), (7, 3),
                                          (64, 40)])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_kernels_equal_plain(dev, width, fanout, weighted):
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward_plain,
        fanout_reduce,
        fanout_reduce_plain,
    )

    g = _gen(dev, width * fanout)
    n, d = 5000, 1234
    h = torch.randn((n, width), generator=g, device=dev, requires_grad=True)
    neigh = torch.randint(-2, n + 2, (d, fanout), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, fanout), generator=g, device=dev) < 0.3] = EMPTY
    w = (torch.rand((d, fanout), generator=g, device=dev) + 0.5
         if weighted else None)
    s, den = fanout_reduce(h, neigh, w)
    s_ref, den_ref = fanout_reduce_plain(h.detach(), neigh, w)
    assert torch.equal(s, s_ref) and torch.equal(den, den_ref)
    gs = torch.randn((d, width), generator=g, device=dev)
    (gh,) = torch.autograd.grad(s, h, gs)
    torch.testing.assert_close(gh, fanout_backward_plain(gs, neigh, w, n),
                               rtol=1e-5, atol=1e-5)


def test_no_backward_launch_for_a_table_without_grad(dev):
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import fanout_reduce

    g = _gen(dev, 0)
    table = torch.randn((100, 8), generator=g, device=dev)
    w = torch.randn((8, 4), device=dev, requires_grad=True)
    neigh = torch.randint(0, 100, (20, 3), generator=g, device=dev,
                          dtype=torch.int32)
    _build.LAUNCHES.reset()
    s, _ = fanout_reduce(table, neigh)
    (s @ w).sum().backward()
    assert _build.LAUNCHES.snapshot() == {"fanout_fwd": 1}


def test_pipelined_engine_matches_serial_on_the_card(dev):
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev)
    losses = []
    for pipeline in (True, False):
        cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                        pipeline=pipeline, calibration_batches=2)
        engine = Engine(ds, cfg).init()
        assert engine.device.type == "cuda"
        losses.append([engine.train_epoch(e)["loss"] for e in range(2)])
    assert np.all(np.isfinite(losses))
    # the backward's atomics order sums differently from run to run
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-5)


def test_a_step_never_waits_on_the_card(dev):
    """Sampling, extract and the train step only queue work on the card: no
    `.item()`, `nonzero` or copy from pageable host memory, each of which
    would stall the pipeline."""
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.train import train_step

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev)
    cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                    calibration_batches=0)
    engine = Engine(ds, cfg).init()
    item = next(Shuffler(ds.train_set, cfg.batch_size).epoch_batches(0))
    # warm-up: loads the kernels and the pinned host pool
    batch, x, labels, _, _ = engine._produce((item, 1, (0, 0)))
    train_step(engine.model, engine.opt, batch.blocks, x, labels,
               batch.num_output, generator(dev, 2), batch.overflow)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch, x, labels, _, _ = engine._produce((item, 3, (0, 1)))
        metrics = train_step(engine.model, engine.opt, batch.blocks, x,
                             labels, batch.num_output, generator(dev, 4),
                             batch.overflow)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))
