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


def _hub_csr(dev, fanout, seed):
    """A CSR whose rows have degree 0, below, at and above ``fanout``, and
    hubs past 2^16, with random neighbour ids."""
    rng = np.random.default_rng(seed)
    small = [0, 1, max(fanout - 1, 0), fanout, fanout + 1, 2 * fanout, 37]
    degrees = np.concatenate([rng.choice(small, size=400),
                              [65_535, 65_536, 65_537, 200_003, 1 << 18]])
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, len(degrees), int(indptr[-1])).astype(np.int32)
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(indices).to(dev), len(degrees))


@pytest.mark.parametrize("fanout", [1, 3, 5, 10, 15])
def test_khop_kernel_equals_plain(dev, fanout):
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import sample_khop0, sample_khop0_plain

    indptr, indices, num_node = _hub_csr(dev, fanout, fanout)
    g = _gen(dev, fanout)
    b = 3 * 256 + 77  # not a multiple of the block
    frontier = torch.randint(0, num_node, (b,), generator=g, device=dev,
                             dtype=torch.int32)
    frontier[-5:] = torch.arange(num_node - 5, num_node, device=dev,
                                 dtype=torch.int32)  # the hubs
    frontier[::9] = EMPTY
    _build.LAUNCHES.reset()
    for seed in range(40):
        u = torch.rand((b, fanout), generator=_gen(dev, 1000 + seed),
                       device=dev)
        out = sample_khop0(indptr, indices, frontier, fanout, u=u)
        ref = sample_khop0_plain(indptr, indices, frontier, fanout, u=u)
        assert torch.equal(out, ref), f"seed {seed}"
    # drawn from a generator, the kernel's uniforms are the plain version's
    out = sample_khop0(indptr, indices, frontier, fanout, _gen(dev, 5))
    ref = sample_khop0_plain(indptr, indices, frontier, fanout, _gen(dev, 5))
    assert torch.equal(out, ref)
    assert _build.LAUNCHES.snapshot() == {"sample_khop": 41}
    assert sample_khop0(indptr, indices, frontier[:0], fanout).shape == (
        0, fanout)


@pytest.mark.parametrize("case", ["dups", "num_prev_0", "all_empty",
                                  "overflow", "tiny_cap"])
def test_unique_kernel_equals_plain(dev, case):
    from xgnn_tpu_torch.ops.unique import unique_seeded, unique_seeded_plain

    rng = np.random.default_rng(len(case))
    num_node, prev_cap, num_prev = 5000, 700, 613
    if case == "num_prev_0":
        num_prev = 0
    prev = np.full(prev_cap, EMPTY, np.int32)
    prev[:num_prev] = rng.choice(num_node, num_prev, replace=False)
    # duplicates among the picks (a narrow id range) and picks that repeat
    # prefix ids
    picks = rng.integers(0, num_node // 3, 7000).astype(np.int32)
    picks[::5] = EMPTY
    if num_prev:
        picks[1::7] = prev[rng.integers(0, num_prev, len(picks[1::7]))]
    ids = np.concatenate([prev, picks])
    if case == "all_empty":
        ids[:] = EMPTY
        num_prev = 0
    out_cap = {"overflow": 1200, "tiny_cap": 10}.get(case, 4096)
    ids_t = torch.from_numpy(ids).to(dev)
    n_prev = torch.tensor(num_prev, dtype=torch.int32).to(dev)
    out = unique_seeded(ids_t, n_prev, prev_cap, out_cap, num_node=num_node)
    ref = unique_seeded_plain(ids_t, n_prev, prev_cap, out_cap)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)
    assert (int(out[1]) > out_cap) == (case in ("overflow", "tiny_cap"))
    with pytest.raises(ValueError, match="num_node"):
        unique_seeded(ids_t, n_prev, prev_cap, out_cap)


def test_sampler_kernels_equal_the_plain_path(dev, monkeypatch):
    """A whole ``Sampler.sample`` through K2 and K3 equals the same batch
    sampled through their plain versions from the same generator seed."""
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.ops import _build, sampling, unique
    from xgnn_tpu_torch.sampler import Sampler

    ds = make_device_dataset(20_000, 100_000, 8, 5, seed=3, device=dev)
    for direct in (True, False):
        sampler = Sampler(ds.graph, RunConfig(batch_size=480,
                                              fanout=(15, 10, 5)),
                          direct_extract=direct)
        seeds = torch.full((sampler.capacities[0],), EMPTY,
                           dtype=torch.int32, device=dev)
        seeds[:480] = torch.from_numpy(ds.train_set[:480]).to(dev)
        _build.LAUNCHES.reset()
        got = sampler.sample(seeds, 480, _gen(dev, 9))
        assert _build.LAUNCHES.snapshot() == {
            "sample_khop": 3, "unique_seeded": 2 if direct else 3}
        with monkeypatch.context() as m:
            m.setattr(sampling, "sample_khop0", sampling.sample_khop0_plain)
            m.setattr(unique, "unique_seeded",
                      lambda ids, num_prev, prev_cap, out_cap, num_node=None:
                      unique.unique_seeded_plain(ids, num_prev, prev_cap,
                                                 out_cap))
            ref = sampler.sample(seeds, 480, _gen(dev, 9))
        assert len(got.blocks) == len(ref.blocks) == 3
        for gb, rb in zip(got.blocks, ref.blocks):
            assert torch.equal(gb.neigh, rb.neigh)
            assert torch.equal(gb.num_src, rb.num_src)
            assert torch.equal(gb.num_dst, rb.num_dst)
            assert (gb.dst_ids is None) == (rb.dst_ids is None)
            if gb.dst_ids is not None:
                assert torch.equal(gb.dst_ids, rb.dst_ids)
        assert torch.equal(got.input_nodes, ref.input_nodes)
        assert torch.equal(got.num_input, ref.num_input)
        assert torch.equal(got.overflow, ref.overflow)


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
