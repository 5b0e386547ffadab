"""The port's CUDA kernels and its pipelined engine on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one.  The machine with the card has no JAX, so run this file
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import os
import subprocess
import sys
import time

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


@pytest.mark.parametrize("width", [1, 47, 128, 256])
def test_gather_rows_bf16_kernel_equals_plain(dev, width):
    """K1 over a bfloat16 table, bit-equal to its plain version: 16-byte
    words at widths 128 and 256, 4-byte words at an even width or from a
    table 2 bytes off 16-byte alignment, 2-byte words at an odd width."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    g = _gen(dev, width)
    n = 3000
    feat = torch.randn((n * width + 1,), generator=g,
                       device=dev).to(torch.bfloat16)
    ids = torch.randint(-5, n + 5, (4099,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::3] = EMPTY
    _build.LAUNCHES.reset()
    for table in (feat[:-1].view(n, width), feat[1:].view(n, width)):
        out = gather_rows(table, ids)
        assert out.dtype == torch.bfloat16
        ref = gather_rows_plain(table, ids)
        assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert _build.LAUNCHES.snapshot() == {"gather_rows_bf16": 2}


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


def _bwd_case(dev, n, d, width, fanout, weighted, seed):
    g = _gen(dev, seed)
    neigh = torch.randint(-2, n + 2, (d, fanout), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, fanout), generator=g, device=dev) < 0.2] = EMPTY
    w = (torch.rand((d, fanout), generator=g, device=dev) + 0.5
         if weighted else None)
    gs = torch.randn((d, width), generator=g, device=dev)
    gd = torch.randn((d, width), generator=g, device=dev)
    return neigh, w, gs, gd


def _within_sum_bound(got, row, neigh, w, gs, gd):
    """Row ``row`` of a backward against its float64 sum, to the bound of
    any float32 summation order: ``n * 2^-24 * sum |terms|`` for n terms
    (one more for the rounded weighted products)."""
    i, k = torch.nonzero(neigh == row, as_tuple=True)
    terms = gs.double()[i]
    if w is not None:
        terms = terms * w.double()[i, k][:, None]
    if gd is not None and row < gd.shape[0]:
        terms = torch.cat([terms, gd.double()[row][None]])
    bound = (terms.shape[0] + 1) * 2.0 ** -24 * terms.abs().sum(0)
    assert torch.all((got[row].double() - terms.sum(0)).abs() <= bound)


@pytest.mark.parametrize("width,fanout", [(128, 5), (256, 10), (7, 3),
                                          (64, 40)])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_backward_kernel_equals_plain(dev, width, fanout, weighted):
    """The segmented backward against the plain version (index_add_, whose
    atomics order the sum freely on the card), rtol/atol 1e-5, with a hub
    picked 10,000 times (sorted in device memory) and a row of 100 picks
    (sorted in shared memory) held to the float32 summation bound instead,
    and rows no pick lands on; two launches equal bit for bit."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
    )

    n, d, hubs = 7000, 5000, (17, 4321)
    neigh, w, gs, gd = _bwd_case(dev, n, d, width, fanout, weighted,
                                 width + fanout)
    neigh[(neigh >= 6500) & (neigh < n)] = EMPTY  # rows no pick lands on
    neigh.view(-1)[:10_000] = hubs[0]
    neigh.view(-1)[10_000:10_100] = hubs[1]
    rest = torch.ones(n, dtype=torch.bool, device=dev)
    rest[list(hubs)] = False
    _build.LAUNCHES.reset()
    for grad_dst in (gd, None):
        gh = fanout_backward(gs, neigh, w, n, grad_dst)
        assert torch.equal(gh, fanout_backward(gs, neigh, w, n, grad_dst))
        ref = fanout_backward_plain(gs, neigh, w, n, grad_dst)
        torch.testing.assert_close(gh[rest], ref[rest], rtol=1e-5, atol=1e-5)
        for row in hubs:
            _within_sum_bound(gh, row, neigh, w, gs, grad_dst)
    assert _build.LAUNCHES.snapshot() == {"fanout_bwd": 4}
    assert torch.all(gh[6500:] == 0)


@pytest.mark.parametrize("width", [7, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_backward_kernel_is_the_cpu_plain_version(dev, width,
                                                         weighted):
    """At a small shape (no row past 32 picks) the kernel sums each row in
    the CPU plain version's order: the two agree bit for bit, and so does
    an empty block (D = 0)."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
    )

    n, d, fanout = 400, 300, 5
    neigh, w, gs, gd = _bwd_case(dev, n, d, width, fanout, weighted, width)
    cpu = [None if t is None else t.cpu() for t in (neigh, w, gs, gd)]
    ref = fanout_backward_plain(cpu[2], cpu[0], cpu[1], n, cpu[3])
    assert torch.equal(fanout_backward(gs, neigh, w, n, gd).cpu(), ref)
    out = fanout_backward(gs[:0], neigh[:0], None if w is None else w[:0],
                          n, gd[:0])
    assert torch.equal(out, torch.zeros((n, width), device=dev))


def test_prefix_fanout_reduce_is_one_backward_launch(dev):
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward_plain,
        prefix_fanout_reduce,
    )

    n, d, width = 3000, 1000, 64
    neigh, _, gs, gd = _bwd_case(dev, n, d, width, 10, False, 1)
    h = torch.randn((n, width), generator=_gen(dev, 2), device=dev,
                    requires_grad=True)
    _build.LAUNCHES.reset()
    h_dst, s, _ = prefix_fanout_reduce(h, neigh)
    (gh,) = torch.autograd.grad((h_dst, s), h, (gd, gs))
    assert _build.LAUNCHES.snapshot() == {"fanout_fwd": 1, "fanout_bwd": 1}
    assert torch.equal(h_dst, h[:d])
    torch.testing.assert_close(gh, fanout_backward_plain(gs, neigh, None, n,
                                                         gd),
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


@pytest.mark.parametrize("table", ["47", "128", "256", "128 unaligned"])
@pytest.mark.parametrize("fanout", [5, 10, 15, 7, 33])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_forward_kernel_is_the_plain_version(dev, table, fanout,
                                                    weighted):
    """Both forms of the forward, the sum and the masked mean, against
    their plain versions on the card bit for bit: the main path's fanouts
    (5, 10, 15, templated) and two others (7, and 33 across two chunks of
    32 picks), float4 lanes (128: one slice, 256: two), float lanes (47 and
    a table 4 bytes off 16-byte alignment), invalid picks and a dst row
    with none."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_reduce,
        fanout_reduce_plain,
        masked_mean,
        masked_mean_plain,
    )

    width = int(table.split()[0])
    g = _gen(dev, width + fanout)
    n, d = 5000, 1234
    if table.endswith("unaligned"):
        h = torch.randn((n * width + 1,), generator=g,
                        device=dev)[1:].view(n, width)
        assert h.data_ptr() % 16 != 0
    else:
        h = torch.randn((n, width), generator=g, device=dev)
    neigh = torch.randint(-2, n + 2, (d, fanout), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, fanout), generator=g, device=dev) < 0.3] = EMPTY
    neigh[7] = EMPTY
    w = (torch.rand((d, fanout), generator=g, device=dev) + 0.5
         if weighted else None)
    _build.LAUNCHES.reset()
    for fn, plain in ((fanout_reduce, fanout_reduce_plain),
                      (masked_mean, masked_mean_plain)):
        out, den = fn(h, neigh, w)
        ref, den_ref = plain(h, neigh, w)
        assert torch.equal(out, ref) and torch.equal(den, den_ref)
    assert _build.LAUNCHES.snapshot() == {"fanout_fwd": 2}
    assert torch.all(out[7] == 0) and float(den[7]) == 0.0


@pytest.mark.parametrize("table", ["47", "128", "256", "128 unaligned"])
@pytest.mark.parametrize("fanout", [5, 10, 15, 7, 33])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_forward_over_bf16_is_the_plain_version(dev, table, fanout,
                                                       weighted):
    """The forward over a bfloat16 table (layer 0 under feat_dtype or
    compute_dtype "bfloat16"), both forms and the dst prefix, against the
    plain version on the card bit for bit: float32 sums and denominators,
    8-byte bfloat16 slices a lane (128, 256) or one element (47, and a
    table 2 bytes off 8-byte alignment); a bfloat16 table that needs a
    gradient is refused."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_reduce,
        fanout_reduce_plain,
        masked_mean,
        masked_mean_plain,
        prefix_masked_mean,
    )

    width = int(table.split()[0])
    g = _gen(dev, width + fanout + 1)
    n, d = 5000, 1234
    flat = torch.randn((n * width + 1,), generator=g,
                       device=dev).to(torch.bfloat16)
    h = (flat[1:] if table.endswith("unaligned") else flat[:-1]).view(
        n, width)
    if table.endswith("unaligned"):
        assert h.data_ptr() % 8 != 0
    neigh = torch.randint(-2, n + 2, (d, fanout), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, fanout), generator=g, device=dev) < 0.3] = EMPTY
    neigh[7] = EMPTY
    w = (torch.rand((d, fanout), generator=g, device=dev) + 0.5
         if weighted else None)
    _build.LAUNCHES.reset()
    for fn, plain in ((fanout_reduce, fanout_reduce_plain),
                      (masked_mean, masked_mean_plain)):
        out, den = fn(h, neigh, w)
        ref, den_ref = plain(h, neigh, w)
        assert out.dtype == den.dtype == torch.float32
        assert torch.equal(out, ref) and torch.equal(den, den_ref)
    h_dst, mean, _ = prefix_masked_mean(h, neigh, w)
    assert torch.equal(mean, out) and h_dst.data_ptr() == h.data_ptr()
    assert _build.LAUNCHES.snapshot() == {"fanout_fwd_bf16": 3}
    with pytest.raises(NotImplementedError, match="bfloat16"):
        masked_mean(h.clone().requires_grad_(), neigh, w)


@pytest.mark.parametrize("width", [7, 128, 256])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_backward_with_denom_is_the_cpu_plain_version(dev, width,
                                                             weighted):
    """The mean form's backward (``denom`` given): at a shape where no src
    row has more than 32 picks, bit-equal to the CPU plain version, which
    divides first, and bit-equal across two launches, with dst rows that
    have no valid pick (divided by 1e-9)."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        masked_mean,
    )

    n, d, fanout = 400, 300, 5
    neigh, w, gs, gd = _bwd_case(dev, n, d, width, fanout, weighted,
                                 width + 3)
    neigh[:4] = EMPTY
    h = torch.randn((n, width), generator=_gen(dev, 5), device=dev)
    _, den = masked_mean(h, neigh, w)
    assert int((den == 0).sum()) >= 4
    cpu = [None if t is None else t.cpu() for t in (neigh, w, gs, gd, den)]
    ref = fanout_backward_plain(cpu[2], cpu[0], cpu[1], n, cpu[3], cpu[4])
    got = fanout_backward(gs, neigh, w, n, gd, den)
    assert torch.equal(got, fanout_backward(gs, neigh, w, n, gd, den))
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("width", [7, 128])
@pytest.mark.parametrize("fanout", [10, 7])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_backward_on_a_large_block_is_the_cpu_plain_version(
        dev, width, fanout, mean, weighted):
    """From 32,768 dst rows on, the rows kernel takes 5 picks of a dst row
    a task (K = 10: two tasks a row; K = 7: 5 and 2) under its register
    cap.  With the prefix gradient and half the gradient entries zero (as
    after ReLU), the sum form and the mean form (``denom`` given) are
    bit-equal to the CPU plain version where no src row has more than 32
    picks, and across two launches."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce_plain,
    )

    n, d = 120_000, 40_000
    neigh, w, gs, gd = _bwd_case(dev, n, d, width, fanout, weighted,
                                 width + fanout)
    gs[torch.rand(gs.shape, generator=_gen(dev, 3), device=dev) < 0.5] = 0.0
    valid = (neigh >= 0) & (neigh < n)
    assert int(torch.bincount(neigh[valid].long(), minlength=n).max()) <= 32
    den = (fanout_reduce_plain(torch.zeros((n, 1), device=dev), neigh, w)[1]
           if mean else None)
    cpu = [None if t is None else t.cpu() for t in (neigh, w, gs, gd, den)]
    ref = fanout_backward_plain(cpu[2], cpu[0], cpu[1], n, cpu[3], cpu[4])
    got = fanout_backward(gs, neigh, w, n, gd, den)
    assert torch.equal(got, fanout_backward(gs, neigh, w, n, gd, den))
    assert torch.equal(got.cpu(), ref)


def _settle():
    """Wait for the card, then give CUPTI time to complete its kernel
    records before a profiler trace stops.  A trace stopped right after
    the synchronize kept its host-side ``cudaLaunchKernel`` events but now
    and then lost some or all of the last kernels' device records (seen on
    an H100 with torch 2.11 and CUDA 12.8, with or without a warm-up step);
    after a short wait it lost none."""
    torch.cuda.synchronize()
    time.sleep(0.2)


def _device_kernels(run):
    """The names of every device event of ``run()`` under the profiler
    (kernels, memsets and copies), and what ``run()`` returned.  A session
    that kept fewer device kernel records than its host-side launch records
    (``cudaLaunchKernel`` and the like) lost some: ``run()`` is profiled
    again, at most twice, as ``chip_smoke.py``'s tooling phase measures a
    pair again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = run()
            _settle()
        events = prof.events()
        launched = sum("LaunchKernel" in e.name for e in events
                       if e.device_type == DeviceType.CPU)
        device = [e.name for e in events if e.device_type == DeviceType.CUDA]
        kernels = [x for x in device
                   if not x.startswith(("Memset", "Memcpy"))]
        if len(kernels) >= launched:
            break
    return device, got


@pytest.mark.parametrize("model", ["graphsage", "pinsage"])
def test_mean_aggregate_launches_no_division(dev, model):
    """SAGEConv and PinSAGEConv divide inside K4: one forward launch a
    layer, and no PyTorch division kernel in the step's forward and
    backward (the profiler's device events, ``_device_kernels``); a mean
    under ``no_grad`` is one kernel on the card."""
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import masked_mean
    from xgnn_tpu_torch.sampler import Sampler

    ds = make_device_dataset(5000, 30_000, 32, 6, seed=2, device=dev,
                             dedup=False)
    cfg = RunConfig(batch_size=128, fanout=(6, 4, 3), num_hidden=32,
                    model=model, dropout=0.0,
                    frontier_capacities=None if model == "pinsage"
                    else (128, 896, 3584, 5000))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(ds.train_set[:128]).to(dev), 128, generator(dev, 1))
    net = build_model(cfg, 32, 6).to(dev)
    torch.cuda.synchronize()

    def step():
        _build.LAUNCHES.reset()
        net(batch.blocks, ds.feat).square().sum().backward()

    names, _ = _device_kernels(step)
    layers = len(batch.blocks)
    assert _build.LAUNCHES.snapshot()["fanout_fwd"] == layers
    assert sum("fanout_fwd_kernel" in x for x in names) == layers
    assert not [x for x in names if "div" in x.lower()]
    neigh = batch.blocks[0].neigh
    with torch.no_grad():
        kernels, _ = _device_kernels(lambda: masked_mean(ds.feat, neigh))
    assert len(kernels) == 1 and "fanout_fwd_kernel" in kernels[0]


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


@pytest.mark.parametrize("fanout", [5, 10, 15])
@pytest.mark.parametrize("rows", [1, 256, 5 * 256 + 1])
@pytest.mark.parametrize("aligned", [True, False])
def test_khop_staged_tiles_equal_plain(dev, fanout, rows, aligned):
    """The fixed-K sampler stages u and out through shared memory by blocks
    of 256 rows: one partial block, one full block, several blocks with a
    ragged last one, and a u off 16-byte alignment (word copies)."""
    from xgnn_tpu_torch.ops.sampling import sample_khop0, sample_khop0_plain

    indptr, indices, num_node = _hub_csr(dev, fanout, rows)
    g = _gen(dev, rows)
    frontier = torch.randint(0, num_node, (rows,), generator=g, device=dev,
                             dtype=torch.int32)
    frontier[::7] = EMPTY
    flat = torch.rand((rows * fanout + 1,), generator=g, device=dev)
    u = (flat[:-1] if aligned else flat[1:]).view(rows, fanout)
    assert (u.data_ptr() % 16 == 0) == aligned
    ref = sample_khop0_plain(indptr, indices, frontier, fanout, u=u)
    assert torch.equal(sample_khop0(indptr, indices, frontier, fanout, u=u),
                       ref)


@pytest.mark.parametrize("fanout", [1, 5, 10, 15, 64])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_with_replacement_kernels_equal_plain(dev, fanout, dedup, aligned):
    """K8a (uniform_wr, and khop1 with dedup) over rows of degree 0, small
    degrees, hubs, EMPTY and ids outside the graph; fanouts 5, 10 and 15
    take the staged kernel (u off 16-byte alignment: word copies), others
    the general one."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import (
        sample_khop1,
        sample_khop1_plain,
        sample_uniform_wr,
        sample_uniform_wr_plain,
    )

    kernel, plain = ((sample_khop1, sample_khop1_plain) if dedup
                     else (sample_uniform_wr, sample_uniform_wr_plain))
    indptr, indices, num_node = _hub_csr(dev, fanout, fanout + dedup)
    g = _gen(dev, fanout)
    b = 3 * 256 + 77
    frontier = torch.randint(0, num_node, (b,), generator=g, device=dev,
                             dtype=torch.int32)
    frontier[-5:] = torch.arange(num_node - 5, num_node, device=dev,
                                 dtype=torch.int32)  # the hubs
    frontier[::9] = EMPTY
    frontier[1::11] = num_node + 3  # outside the contract: degree 0
    _build.LAUNCHES.reset()
    for seed in range(10):
        flat = torch.rand((b * fanout + 1,), generator=_gen(dev, 100 + seed),
                          device=dev)
        u = (flat[:-1] if aligned else flat[1:]).view(b, fanout)
        out = kernel(indptr, indices, frontier, fanout, u=u)
        assert torch.equal(out, plain(indptr, indices, frontier, fanout,
                                      u=u)), f"seed {seed}"
    out = kernel(indptr, indices, frontier, fanout, _gen(dev, 5))
    assert torch.equal(out, plain(indptr, indices, frontier, fanout,
                                  _gen(dev, 5)))
    assert _build.LAUNCHES.snapshot() == {"sample_wr": 11}
    assert kernel(indptr, indices, frontier[:0], fanout).shape == (0, fanout)
    with pytest.raises(ValueError):
        kernel(indptr, indices, frontier, 65)


@pytest.mark.parametrize("w,l,k,p", [
    (4, 3, 5, 0.5),  # the bench's walk: the kernel built for it
    (2, 5, 3, 0.0),
    (3, 4, 12, 1.0),
    (8, 8, 64, 0.3),  # the most visits the kernel keeps
    (1, 1, 1, 0.7),
])
def test_random_walk_kernel_equals_plain(dev, w, l, k, p):
    """K9 over a graph of few ids (repeated visits, ties in count), with
    EMPTY seeds, seeds of degree 0, hubs and ids outside the graph."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.random_walk import (
        sample_random_walk,
        sample_random_walk_plain,
    )

    rng = np.random.default_rng(w * 10 + l)
    degrees = np.concatenate([rng.choice([0, 1, 2, 3, 8, 40], size=500),
                              [70_000, 1 << 17]])
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, 30, int(indptr[-1])).astype(np.int32)
    num_node = len(degrees)
    indices[::97] = num_node - 1  # walkers reach the hubs
    indptr, indices = (torch.from_numpy(a).to(dev) for a in (indptr, indices))
    b = 3 * 64 + 17  # not a multiple of the block
    frontier = torch.randint(0, num_node, (b,), generator=_gen(dev, k),
                             device=dev, dtype=torch.int32)
    frontier[::7] = EMPTY
    frontier[1::13] = num_node + 5
    frontier[2] = int(np.flatnonzero(degrees == 0)[0])
    frontier[-2:] = torch.tensor([num_node - 2, num_node - 1])
    kw = dict(num_random_walk=w, random_walk_length=l, restart_prob=p)
    _build.LAUNCHES.reset()
    for seed in range(10):
        g = _gen(dev, 200 + seed)
        u = (torch.rand((l, b, w), generator=g, device=dev),
             torch.rand((l, b, w), generator=g, device=dev))
        got = sample_random_walk(indptr, indices, frontier, k, u=u, **kw)
        want = sample_random_walk_plain(indptr, indices, frontier, k, u=u,
                                        **kw)
        for a, c in zip(got, want):
            assert torch.equal(a, c), f"seed {seed}"
    got = sample_random_walk(indptr, indices, frontier, k, _gen(dev, 3), **kw)
    want = sample_random_walk_plain(indptr, indices, frontier, k,
                                    _gen(dev, 3), **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert _build.LAUNCHES.snapshot() == {"random_walk": 11}
    assert float(got[1].sum()) > 0
    neigh, weights = sample_random_walk(indptr, indices, frontier[:0], k,
                                        **kw)
    assert neigh.shape == weights.shape == (0, k)


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


def _dedup_inputs(rng, num_node, prev_cap, num_prev, m, lo=0, hi=None):
    """A prefix of ``num_prev`` distinct ids (EMPTY after) and ``m`` picks
    from ``[lo, hi)``, a fifth EMPTY and some repeating prefix ids."""
    hi = num_node if hi is None else hi
    prev = np.full(prev_cap, EMPTY, np.int32)
    prev[:num_prev] = rng.choice(num_node, num_prev, replace=False)
    picks = rng.integers(lo, hi, m).astype(np.int32)
    picks[rng.random(m) < 0.2] = EMPTY
    if num_prev:
        picks[1::7] = prev[rng.integers(0, num_prev, len(picks[1::7]))]
    return prev, picks, num_prev


def _on_card(dev, case):
    prev, picks, num_prev = case
    return (torch.from_numpy(prev).to(dev), torch.from_numpy(picks).to(dev),
            torch.tensor(num_prev, dtype=torch.int32).to(dev))


def _dedup(dev, case, out_cap, num_node):
    """K3's split form on ``case`` (numpy prefix, picks, num_prev), queued
    on the current stream: its outputs and its inputs on the card."""
    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    args = _on_card(dev, case)
    return unique_seeded_split(*args, out_cap, num_node=num_node), args


def _assert_plain(out, args, out_cap):
    from xgnn_tpu_torch.ops.unique import unique_seeded_split_plain

    ref = unique_seeded_split_plain(*args, out_cap)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and torch.equal(o, r)


@pytest.mark.parametrize("overlap", [True, False])
def test_unique_state_holds_across_calls(dev, overlap):
    """Calls back to back on one stream, with no sync between them, on ids
    that overlap (one range) or are disjoint (a range each)."""
    rng = np.random.default_rng(int(overlap))
    num_node, calls = 60_000, 6
    outs = []
    for c in range(calls):
        lo, hi = (0, 20_000) if overlap else (c * 10_000, (c + 1) * 10_000)
        case = _dedup_inputs(rng, num_node, 900, 800, 9000, lo, hi)
        outs.append(_dedup(dev, case, 8192, num_node))
    for out, args in outs:
        _assert_plain(out, args, 8192)


def test_unique_after_an_overflowed_call(dev):
    rng = np.random.default_rng(3)
    case = _dedup_inputs(rng, 5000, 700, 613, 7000, 0, 5000 // 3)
    tiny = _dedup(dev, case, 10, 5000)
    assert int(tiny[0][1]) > 10
    for cap in (10, 4096):
        _assert_plain(*_dedup(dev, case, cap, 5000), cap)
    other = _dedup_inputs(rng, 5000, 700, 613, 7000)
    _assert_plain(*_dedup(dev, other, 4096, 5000), 4096)
    _assert_plain(*tiny, 10)


def test_unique_num_node_changing_between_calls(dev):
    rng = np.random.default_rng(4)
    outs = []
    for num_node in (5000, 70_001, 5000, 123, 70_001, 1):
        case = _dedup_inputs(rng, num_node, 64, min(50, num_node), 3000)
        outs.append((_dedup(dev, case, 2048, num_node), 2048))
    for (out, args), cap in outs:
        _assert_plain(out, args, cap)


def test_unique_two_streams_interleaved(dev):
    """Two streams with no ordering between them each keep a state of their
    own."""
    from xgnn_tpu_torch.ops import unique

    rng = np.random.default_rng(5)
    num_node = 200_000
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    # copied to the card before either stream starts
    inputs = [[_on_card(dev, _dedup_inputs(rng, num_node, 4000, 3500, 60_000,
                                           0, 80_000))
               for _ in range(5)] for _ in streams]
    torch.cuda.synchronize()
    outs = [[], []]
    for i in range(5):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                args = inputs[s][i]
                outs[s].append(unique.unique_seeded_split(
                    *args, 40_000, num_node=num_node))
    states = []
    for stream in streams:
        with torch.cuda.stream(stream):
            states.append(unique.state(dev, num_node))
    assert states[0] is not states[1]
    torch.cuda.synchronize()
    for s in range(2):
        for out, args in zip(outs[s], inputs[s]):
            _assert_plain(out, args, 40_000)


def test_unique_threads_sharing_a_stream(dev):
    """Threads that queue K3 on one stream share its state: each call's
    three launches are queued under one lock, so the calls do not
    interleave, and each takes the generation its predecessor left on the
    card."""
    import sys
    import threading

    rng = np.random.default_rng(10)
    num_node, cap = 40_000, 8192
    inputs = [[_on_card(dev, _dedup_inputs(rng, num_node, 600, 500, 6000))
               for _ in range(8)] for _ in range(6)]
    torch.cuda.synchronize()
    outs = [[] for _ in inputs]

    def work(t):
        from xgnn_tpu_torch.ops.unique import unique_seeded_split

        for args in inputs[t]:
            outs[t].append(unique_seeded_split(*args, cap,
                                               num_node=num_node))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(len(inputs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    for per_thread, got in zip(inputs, outs):
        assert len(got) == len(per_thread)
        for out, args in zip(got, per_thread):
            _assert_plain(out, args, cap)


def test_unique_generation_wrap(dev):
    """The stamp wraps after 2^32 - 1 calls: the call of the last
    generation clears the state on the card, and the next starts again at
    1."""
    from xgnn_tpu_torch.ops import unique

    rng = np.random.default_rng(6)
    num_node = 30_000
    _assert_plain(*_dedup(dev, _dedup_inputs(rng, num_node, 500, 400, 5000),
                          4096, num_node), 4096)
    st = unique.state(dev, num_node)
    st.gen = unique._MAX_GEN - 2
    for _ in range(4):
        case = _dedup_inputs(rng, num_node, 500, 400, 5000)
        _assert_plain(*_dedup(dev, case, 4096, num_node), 4096)
    assert st.gen == 2


def test_unique_look_back_across_many_tiles(dev):
    """About 3M nodes: 367 scan tiles of 8,192 ids, every one with new ids;
    once with room for them all and once overflowed."""
    rng = np.random.default_rng(7)
    num_node = 3_000_017
    case = _dedup_inputs(rng, num_node, 60_000, 59_000, 2_000_000)
    for cap in (2_600_000, 1_000_000):
        out, args = _dedup(dev, case, cap, num_node)
        _assert_plain(out, args, cap)
        assert (int(out[1]) > cap) == (cap == 1_000_000)


def test_unique_hub_repeated_among_the_picks(dev):
    rng = np.random.default_rng(8)
    num_node = 100_000
    prev, picks, num_prev = _dedup_inputs(rng, num_node, 2000, 1900, 40_000)
    picks[::8] = 31_337  # a hub no prefix holds (5,000 times)
    picks[3::9] = prev[17]  # a prefix id picked thousands of times
    prev[prev == 31_337] = EMPTY
    _assert_plain(*_dedup(dev, (prev, picks, num_prev), 50_000, num_node),
                  50_000)


@pytest.mark.parametrize("out_cap", [4096, 1200, 10])
def test_unique_split_equals_unique_seeded(dev, out_cap):
    from xgnn_tpu_torch.ops.unique import unique_seeded, unique_seeded_plain

    rng = np.random.default_rng(out_cap)
    case = _dedup_inputs(rng, 5000, 700, 613, 7000, 0, 5000 // 3)
    split, (prefix, picks, n_prev) = _dedup(dev, case, out_cap, 5000)
    ids = torch.cat([prefix, picks])
    full = unique_seeded(ids, n_prev, 700, out_cap, num_node=5000)
    assert torch.equal(split[0], full[0]) and torch.equal(split[1], full[1])
    assert torch.equal(split[2], full[2][700:])
    for o, r in zip(full, unique_seeded_plain(ids, n_prev, 700, out_cap)):
        assert torch.equal(o, r)


def test_unique_is_three_launches_and_allocates_only_its_outputs(dev):
    """K3's call is three kernels on the profiler's device events.  The
    trace waits for CUPTI before it stops (``_settle``), and a session that
    lost records is taken again (``_device_kernels``)."""
    from xgnn_tpu_torch.ops import unique

    rng = np.random.default_rng(9)
    num_node, cap = 2_449_029, 1_007_360
    case = _dedup_inputs(rng, num_node, 133_376, 123_000, 1_333_760)
    args = _on_card(dev, case)
    _assert_plain(*_dedup(dev, case, cap, num_node), cap)  # state made
    torch.cuda.synchronize()

    def call():
        before = torch.cuda.memory_allocated(dev)
        out = unique.unique_seeded_split(*args, cap, num_node=num_node)
        return out, torch.cuda.memory_allocated(dev) - before

    kernels, (out, grown) = _device_kernels(call)
    _assert_plain(out, args, cap)
    assert len(kernels) == 3, kernels
    sizes = [t.numel() * t.element_size() for t in out]
    assert sum(sizes) <= grown <= sum(-(-b // 512) * 512 for b in sizes)
    assert unique.state(dev, num_node).buf.numel() * 8 < 25 * 2**20


def test_sampler_kernels_equal_the_plain_path(dev, monkeypatch):
    """Two batches of ``Sampler.sample`` in a row through K2 and K3 equal
    the same batches sampled through their plain versions from the same
    generator seeds."""
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.ops import _build, sampling, unique
    from xgnn_tpu_torch.sampler import Sampler

    ds = make_device_dataset(20_000, 100_000, 8, 5, seed=3, device=dev,
                             dedup=False)
    for direct in (True, False):
        sampler = Sampler(ds.graph, RunConfig(batch_size=480,
                                              fanout=(15, 10, 5)),
                          direct_extract=direct)
        for batch in range(2):
            seeds = torch.full((sampler.capacities[0],), EMPTY,
                               dtype=torch.int32, device=dev)
            seeds[:480] = torch.from_numpy(
                ds.train_set[480 * batch:480 * (batch + 1)]).to(dev)
            _build.LAUNCHES.reset()
            got = sampler.sample(seeds, 480, _gen(dev, 9 + batch))
            assert _build.LAUNCHES.snapshot() == {
                "sample_khop": 3, "unique_seeded": 2 if direct else 3}
            with monkeypatch.context() as m:
                m.setattr(sampling, "sample_khop0",
                          sampling.sample_khop0_plain)
                m.setattr(unique, "unique_seeded_split",
                          lambda prefix, picks, num_prev, out_cap,
                          num_node=None: unique.unique_seeded_split_plain(
                              prefix, picks, num_prev, out_cap))
                ref = sampler.sample(seeds, 480, _gen(dev, 9 + batch))
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

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             dedup=False)
    losses = []
    for pipeline in (True, False):
        cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                        pipeline=pipeline, calibration_batches=2)
        engine = Engine(ds, cfg).init()
        assert engine.device.type == "cuda"
        losses.append([engine.train_epoch(e)["loss"] for e in range(2)])
    assert np.all(np.isfinite(losses))
    # the two loops need not round alike (cuBLAS promises no fixed order)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4, atol=1e-5)


def test_a_step_never_waits_on_the_card(dev):
    """Sampling, extract and the train step only queue work on the card: no
    `.item()`, `nonzero` or copy from pageable host memory, each of which
    would stall the pipeline."""
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.train import train_step

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             dedup=False)
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


# ---------------------------------------------------- K7 pick multiplicity
@pytest.mark.parametrize("shape,num_rows", [((1007, 5), 3000),
                                            ((133, 10), 50),
                                            ((8, 15), 2_449_029),
                                            ((3, 1), 7)])
def test_pick_multiplicity_kernel_equals_plain(dev, shape, num_rows):
    """Exact, with EMPTY and out-of-range picks, on aligned ids (16-byte
    loads and a ragged tail) and on an unaligned view (4-byte loads)."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.degree import (
        pick_multiplicity,
        pick_multiplicity_plain,
    )

    g = _gen(dev, num_rows)
    ids = torch.randint(-3, min(num_rows, 400) + 3, shape, generator=g,
                        device=dev, dtype=torch.int32)
    ids[torch.rand(shape, generator=g, device=dev) < 0.3] = EMPTY
    _build.LAUNCHES.reset()
    out, _ = pick_multiplicity(ids, num_rows)
    assert out.dtype == torch.int32
    assert torch.equal(out, pick_multiplicity_plain(ids, num_rows)[0])
    flat = ids.reshape(-1)[1:]
    assert torch.equal(pick_multiplicity(flat, num_rows)[0],
                       pick_multiplicity_plain(flat, num_rows)[0])
    assert _build.LAUNCHES.snapshot() == {"pick_multiplicity": 2}
    empty = torch.full(shape, EMPTY, dtype=torch.int32, device=dev)
    assert int(pick_multiplicity(empty, num_rows)[0].abs().sum()) == 0


def _k7_equal(ids, num_rows):
    """The kernel's counts and weights against the plain version's."""
    from xgnn_tpu_torch.ops import degree

    ref, ref_w = degree.pick_multiplicity_plain(ids, num_rows)
    cnt, w = degree.pick_multiplicity(ids, num_rows)
    torch.cuda.synchronize()
    assert cnt.dtype == torch.int32 and cnt.shape == ids.shape
    assert w.dtype == torch.float32 and w.shape == ids.shape
    assert torch.equal(cnt, ref) and torch.equal(w, ref_w)
    return ref


@pytest.mark.parametrize("case", ["hub past 2^16", "all EMPTY", "rows 0",
                                  "rows 1", "n 1", "n 3", "unaligned n 5",
                                  "unaligned view"])
def test_pick_multiplicity_edge_cases(dev, case):
    """Exact, with GCN's weights bit-equal to
    torch.rsqrt(torch.clamp(counts.float(), min=1)) on the card."""
    g = _gen(dev, 3)
    if case == "hub past 2^16":
        ids = torch.randint(100, 5000, (40_000, 3), generator=g, device=dev,
                            dtype=torch.int32)
        ids[:, 1] = 77  # 40,000 picks of 77 ...
        ids[:30_000, 2] = 77  # ... and 30,000 more: 70,000 > 2^16
        ref = _k7_equal(ids, 5000)
        assert int(ref[0, 1]) == 70_000
        return
    if case == "all EMPTY":
        ids = torch.full((1001, 5), EMPTY, dtype=torch.int32, device=dev)
        assert int(_k7_equal(ids, 3000).abs().sum()) == 0
        return
    if case in ("rows 0", "rows 1"):
        rows = int(case[-1])
        ids = torch.randint(-2, 3, (777,), generator=g, device=dev,
                            dtype=torch.int32)
        ref = _k7_equal(ids, rows)
        assert int(ref.max()) == (0 if rows == 0 else int((ids == 0).sum()))
        return
    if case.startswith("n "):
        ids = torch.tensor([4, 4, EMPTY][:int(case[-1])], dtype=torch.int32,
                           device=dev)
        _k7_equal(ids, 10)
        return
    base = torch.randint(0, 300, (4 * 4099 + 1,), generator=g, device=dev,
                         dtype=torch.int32)
    ids = base[1:6] if case == "unaligned n 5" else base[1:]
    assert ids.data_ptr() % 16
    _k7_equal(ids, 300)


@pytest.mark.parametrize("shape,num_rows", [((1_007_360, 5), 2_449_029),
                                            ((133_376, 10), 1_007_360),
                                            ((8000, 15), 133_376)])
def test_pick_multiplicity_at_the_main_path_shapes(dev, shape, num_rows):
    """GCN's three layers' shapes (power-law picks, 5% EMPTY): exact, one
    launch counted a call."""
    from xgnn_tpu_torch.ops import _build

    g = _gen(dev, num_rows)
    u = torch.rand(shape, generator=g, device=dev)
    ids = (num_rows * u.pow(2.0)).to(torch.int32)
    ids[torch.rand(shape, generator=g, device=dev) < 0.05] = EMPTY
    _k7_equal(ids, num_rows)
    _build.LAUNCHES.reset()
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    pick_multiplicity(ids, num_rows)
    pick_multiplicity(ids, num_rows)
    assert _build.LAUNCHES.snapshot() == {"pick_multiplicity": 2}


def test_pick_multiplicity_is_a_memset_and_two_kernels(dev):
    """A call is a memset of the bins, then the count and gather launches,
    with the weights written by the last (no elementwise launch); exact."""
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    rows = 1000
    ids = torch.randint(0, rows, (8000, 15), generator=_gen(dev, 4),
                        device=dev, dtype=torch.int32)
    _k7_equal(ids, rows)
    records, _ = _device_kernels(lambda: pick_multiplicity(ids, rows))
    kernels = [r for r in records if "multiplicity_kernel" in r]
    assert len(records) == 3 and len(kernels) == 2
    assert records[0].startswith("Memset")


# ------------------------------------------------- K5 edge-softmax attend
def _attend_inputs(dev, mode, heads, width, seed, n=3000, d=1500, k=10,
                   dtype=None):
    """Picks with repeats, EMPTY and out-of-range ids, three all-EMPTY dst
    rows, a src row picked 500 times (past one warp's 32) so that whole dst
    rows repeat one id, and a dst row with one valid pick.  With ``dtype``
    the float32 table holds values of that type."""
    g = _gen(dev, seed)
    table = torch.randn((n, width), generator=g, device=dev)
    if dtype is not None:
        table = table.to(dtype).float()
    neigh = torch.randint(-2, n + 2, (d, k), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, k), generator=g, device=dev) < 0.2] = EMPTY
    neigh.view(-1)[100:600] = 11
    neigh[7:10] = EMPTY
    neigh[3] = EMPTY
    neigh[3, k // 2] = 5
    el = torch.randn((d, heads), generator=g, device=dev)
    if mode == "shared":
        proj = 0.1 * torch.randn((width, heads), generator=g, device=dev)
    else:
        proj = 0.1 * torch.randn((heads, width // heads), generator=g,
                                 device=dev)
    # el_dst off leaky_relu's kink: a pre-activation within 1e-4 of 0 may
    # fall on two sides of it in the kernel's and the plain version's
    # float32 scores, and their gradients then differ by the derivative's
    # jump (1 against 0.2), two correct subgradients
    valid = (neigh >= 0) & (neigh < n)
    rows = table[torch.where(valid, neigh, 0).reshape(-1)]
    if mode == "shared":
        score = (rows @ proj).view(d, k, heads)
    else:
        score = (rows.view(d * k, heads, -1) * proj).sum(-1).view(d, k,
                                                                   heads)
    near = (((el[:, None, :] + score).abs() < 1e-4)
            & valid[:, :, None]).any(1)
    return table, neigh, el + 1e-3 * near, proj


def _rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


_ATTEND_CASES = [("shared", h, w, 10) for h in (1, 2, 8)
                 for w in (47, 128, 256)]
_ATTEND_CASES += [("per_head", h, w, 10) for h in (1, 2, 8)
                  for w in (128, 256)]
_ATTEND_CASES += [("per_head", 1, 47, 10)]
# the main path's fanouts at 4 and 8 heads, and rows of two pick windows
_ATTEND_CASES += [("shared", h, w, k) for h in (4, 8) for w in (128, 256)
                  for k in (5, 10, 15)]
_ATTEND_CASES += [("shared", 8, 128, 40), ("per_head", 2, 128, 40)]


@pytest.mark.parametrize("mode,heads,width,fanout", _ATTEND_CASES)
def test_attend_kernels_equal_plain(dev, mode, heads, width, fanout):
    """Forward (out, m, s) against the plain version at rtol/atol 1e-5;
    backward g_table and g_el_dst at rtol/atol 1e-4, g_proj by its relative
    norm, 1e-5.  The backward's looser bound: each pick's g_e is a
    difference of two W-term dot products (g_out . payload - dot, dot =
    sum_k a_k g_out . payload_k), whose float32 rounding (2^-24 times the
    sum of the terms' magnitudes, about 1e-5 at W = 256) the difference
    keeps while the values cancel, and g_table sums up to 500 such rows of
    one src row in another order than the plain version's index_add_.  Two
    launches of the forward and of the backward equal bit for bit (no
    float atomics)."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.attend import (
        attend_backward,
        attend_backward_plain,
        attend_forward,
        attend_forward_plain,
    )

    table, neigh, el, proj = _attend_inputs(dev, mode, heads, width,
                                            heads * 1000 + width + fanout,
                                            k=fanout)
    _build.LAUNCHES.reset()
    out, m, s = attend_forward(table, neigh, el, proj, mode)
    for a, b in zip((out, m, s), attend_forward(table, neigh, el, proj,
                                                mode)):
        assert torch.equal(a, b)
    ref = attend_forward_plain(table, neigh, el, proj, mode)
    for name, a, b in zip(("out", "m", "s"), (out, m, s), ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                   msg=f"forward {name}")
    assert torch.all(out[7:10] == 0)
    g_out = torch.randn(out.shape, generator=_gen(dev, 1), device=dev)
    for need_table in (True, False):
        got = attend_backward(g_out, table, neigh, el, proj, m, s, mode,
                              need_table)
        again = attend_backward(g_out, table, neigh, el, proj, m, s, mode,
                                need_table)
        want = attend_backward_plain(g_out, table, neigh, el, proj, m, s,
                                     mode, need_table)
        assert (got[0] is None) == (not need_table)
        for a, b in zip(got, again):
            assert a is None or torch.equal(a, b)
        if need_table:
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
        assert _rel_norm(got[2], want[2]) < 1e-5
    assert _build.LAUNCHES.snapshot() == {"attend_fwd": 2, "attend_bwd": 4}


def test_attend_autograd_on_the_card_equals_the_cpu(dev):
    """The Function on the card against the same Function on the CPU (the
    plain versions), every gradient."""
    from xgnn_tpu_torch.ops.attend import gat_attend

    for mode, heads, width in (("shared", 2, 64), ("per_head", 2, 48)):
        inputs = _attend_inputs(dev, mode, heads, width, 3, n=500, d=300)
        table, neigh, el, proj = inputs
        g_out = None
        grads = []
        for where in (dev, torch.device("cpu")):
            leaves = [t.to(where).requires_grad_(True)
                      for t in (table, el, proj)]
            out = gat_attend(leaves[0], neigh.to(where), leaves[1],
                             leaves[2], mode)
            if g_out is None:
                g_out = torch.randn(out.shape, generator=_gen(dev, 2),
                                    device=dev)
            grads.append([out] + list(torch.autograd.grad(
                out, leaves, g_out.to(where))))
        for a, b in zip(*grads):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_attend_refuses_past_its_registers_and_across_devices(dev):
    from xgnn_tpu_torch.ops.attend import gat_attend

    neigh = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gat_attend(torch.zeros((10, 512), device=dev), neigh,
                   torch.zeros((3, 8), device=dev),
                   torch.zeros((512, 8), device=dev), "shared")
    with pytest.raises(ValueError, match="different devices"):
        gat_attend(torch.zeros((10, 8), device=dev), neigh.cpu(),
                   torch.zeros((3, 1), device=dev),
                   torch.zeros((8, 1), device=dev), "shared")
    with pytest.raises(ValueError, match="different devices"):
        gat_attend(torch.zeros((10, 8)), neigh, torch.zeros((3, 1)),
                   torch.zeros((8, 1)), "shared")


def _one_head_case(dev, mode, width, fanout, seed, hub=0):
    """K5's one-head backward on _attend_inputs' picks (the first ``hub``
    of them on src row 17): the backward's arguments, a prefix projection
    ``wl`` (shared mode), and the dst-row pass's ``g_el``, its ``a`` and
    ``g_pre`` a pick and the rank-1 row ``u``."""
    from xgnn_tpu_torch.ops.attend import _bwd_rows, attend_forward

    d = 1500
    table, neigh, el, proj = _attend_inputs(dev, mode, 1, width, seed, d=d,
                                            k=fanout)
    neigh.view(-1)[:hub] = 17
    _, m, s = attend_forward(table, neigh, el, proj, mode)
    g = _gen(dev, seed + 1)
    g_out = torch.randn((d, 1, width), generator=g, device=dev)
    wl = (0.1 * torch.randn((width, 1), generator=g, device=dev)
          if mode == "shared" else None)
    args = (g_out, table, neigh, el, proj, m, s, mode)
    g_el, _, a, g_pre, per_pick = _bwd_rows(*args, True)
    assert per_pick is None and a.shape == g_pre.shape == neigh.shape
    u = proj[:, 0] if mode == "shared" else proj[0]
    return args, wl, g_el, a, g_pre, u


@pytest.mark.parametrize("mode,width", [("shared", 47), ("shared", 128),
                                        ("shared", 256), ("per_head", 47),
                                        ("per_head", 128)])
@pytest.mark.parametrize("fanout", [10, 40])
def test_one_head_attend_backward_is_the_plain_sum(dev, mode, width, fanout):
    """At one head the table's gradient is K4's segmented sum over g_out
    with weights a, its rank-1 term (sum g_pre) * u and (shared mode) the
    prefix's g_el @ wl.T, from the dst-row pass's two floats a pick.  Given
    the kernel's a and g_pre, it equals the CPU plain version bit for bit
    on every src row of at most 32 picks, and the rows past 32 (the long
    rows' kernel; src row 11 has over 300) within the float32 summation
    bound; invalid picks carry
    a = g_pre = 0; two launches equal bit for bit; ``g_el`` and ``g_proj``
    are those of the backward without the table's gradient."""
    from xgnn_tpu_torch.ops.attend import attend_backward
    from xgnn_tpu_torch.ops.fanout import fanout_backward_plain

    args, wl, g_el, a, g_pre, u = _one_head_case(dev, mode, width, fanout,
                                                 width + fanout)
    neigh, n = args[2], args[1].shape[0]
    valid = (neigh >= 0) & (neigh < n)
    assert torch.all(a[~valid] == 0) and torch.all(g_pre[~valid] == 0)
    for prefix in ((None, wl) if wl is not None else (None,)):
        got = attend_backward(*args, True, prefix)
        again = attend_backward(*args, True, prefix)
        none = attend_backward(*args, False, prefix)
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        assert torch.equal(got[1], none[1]) and torch.equal(got[2], none[2])
        gd = None if prefix is None else (got[1] @ prefix.T).contiguous()
        cpu = [None if t is None else t.cpu()
               for t in (args[0].view(neigh.shape[0], width), neigh, a, gd,
                         g_pre, u)]
        ref = fanout_backward_plain(cpu[0], cpu[1], cpu[2], n, cpu[3],
                                    c=cpu[4], u=cpu[5])
        count = torch.bincount(neigh[valid].long(), minlength=n).cpu()
        short = count <= 32
        assert torch.equal(got[0].cpu()[short], ref[short])
        assert int(count[11]) > 300
        for row in torch.nonzero(~short)[:, 0].tolist():
            _within_rank1_bound(got[0], row, args[0], neigh, a, g_pre, u, gd)


def _within_rank1_bound(got, row, g_out, neigh, a, g_pre, u, gd):
    """Row ``row`` of the one-head table gradient against its float64
    value, to the bound of any float32 summation order."""
    i, k = torch.nonzero(neigh == row, as_tuple=True)
    terms = g_out.double().view(neigh.shape[0], -1)[i] * a.double()[i, k,
                                                                     None]
    c = g_pre.double()[i, k]
    exact = terms.sum(0) + c.sum() * u.double()
    size = terms.abs().sum(0) + c.abs().sum() * u.double().abs()
    if gd is not None and row < gd.shape[0]:
        exact, size = exact + gd[row].double(), size + gd[row].double().abs()
    bound = (len(i) + 3) * 2.0 ** -24 * size
    assert torch.all((got[row].double() - exact).abs() <= bound)


def test_one_head_attend_backward_hub_of_10000_picks(dev):
    """A src row picked 10,000 times goes through the long rows' kernel
    (its keys sorted in device memory past 8,192) with the rank-1 term and
    the prefix: within the float32 summation bound of its float64 sum, and
    bit-equal across two launches."""
    from xgnn_tpu_torch.ops.attend import attend_backward

    args, wl, g_el, a, g_pre, u = _one_head_case(dev, "shared", 128, 10, 5,
                                                 hub=10_000)
    got = attend_backward(*args, True, wl)
    assert torch.equal(got[0], attend_backward(*args, True, wl)[0])
    assert int((args[2] == 17).sum()) >= 10_000
    _within_rank1_bound(got[0], 17, args[0], args[2], a, g_pre, u,
                        (g_el @ wl.T).contiguous())


def test_one_head_attend_backward_writes_no_row_a_pick(dev):
    """At one head the backward's peak allocation stays under the table's
    gradient plus 16 MiB: no (D * K, W) buffer (200 MB here), while the
    8-head backward on the same picks allocates one."""
    from xgnn_tpu_torch.ops.attend import attend_backward, attend_forward

    n, d, k, width = 30_000, 20_000, 10, 256
    rows = d * k * width * 4
    for heads in (1, 8):
        table, neigh, el, proj = _attend_inputs(dev, "shared", heads, width,
                                                9, n=n, d=d, k=k)
        _, m, s = attend_forward(table, neigh, el, proj, "shared")
        g_out = torch.randn((d, heads, width), generator=_gen(dev, 2),
                            device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        attend_backward(g_out, table, neigh, el, proj, m, s, "shared", True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if heads == 1:
            assert peak < n * width * 4 + 16 * 2**20 < rows
        else:
            assert peak >= rows


@pytest.mark.parametrize("heads", [1, 8])
def test_attend_prefix_on_the_card_equals_the_cpu(dev, heads):
    """``gat_attend_prefix`` on the card against the same Function on the
    CPU (the plain versions), at K5's tolerances: the output at 1e-5, the
    gradient w.r.t. h_src (the table's, the prefix's folded in) at
    rtol/atol 1e-4, wr's (g_proj) by its relative norm at 1e-5 and wl's (a
    sum of g_el_dst's rows, held at 1e-4) at 1e-4; under ``no_grad`` one
    forward launch and nothing else."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.attend import gat_attend_prefix

    n, d, width = 900, 300, 64
    table, neigh, _, wr = _attend_inputs(dev, "shared", heads, width, 4,
                                         n=n, d=d)
    wl = 0.1 * torch.randn((width, heads), generator=_gen(dev, 6),
                           device=dev)
    g_out = torch.randn((d, heads, width), generator=_gen(dev, 7),
                        device=dev)
    results = []
    for where in (dev, torch.device("cpu")):
        leaves = [t.to(where).requires_grad_(True) for t in (table, wl, wr)]
        _build.LAUNCHES.reset()
        out = gat_attend_prefix(leaves[0], neigh.to(where), leaves[1],
                                leaves[2])
        grads = torch.autograd.grad(out, leaves, g_out.to(where))
        if where == dev:
            assert _build.LAUNCHES.snapshot() == {"attend_fwd": 1,
                                                  "attend_bwd": 1}
        results.append([out] + list(grads))
    (out, g_h, g_wl, g_wr), want = results
    torch.testing.assert_close(out.cpu(), want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_h.cpu(), want[1], rtol=1e-4, atol=1e-4)
    assert _rel_norm(g_wl.cpu(), want[2]) < 1e-4
    assert _rel_norm(g_wr.cpu(), want[3]) < 1e-5
    _build.LAUNCHES.reset()
    with torch.no_grad():
        out = gat_attend_prefix(table, neigh, wl, wr)
    assert torch.equal(out, results[0][0].detach())
    assert _build.LAUNCHES.snapshot() == {"attend_fwd": 1}


# ------------------------------------------------------- GCN and GAT steps
@pytest.mark.parametrize("model,heads", [("gcn", 1), ("gat", 1), ("gat", 8),
                                         ("pinsage", 1), ("mlp", 1)])
def test_zoo_step_on_the_card_equals_the_cpu(dev, model, heads):
    """One forward and backward of the GNN on a sampled batch: logits and
    every gradient on the card against the CPU plain path, and the
    kernels' launches."""
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.sampler import Sampler

    ds = make_device_dataset(5000, 30_000, 32, 6, seed=2, device=dev,
                             dedup=False)
    cfg = RunConfig(batch_size=128, fanout=(6, 4, 3), num_hidden=32,
                    model=model, num_head=heads, dropout=0.0,
                    # PinSAGE: two walk layers at the default capacities
                    frontier_capacities=None if model == "pinsage"
                    else (128, 896, 3584, 5000))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(ds.train_set[:128]).to(dev), 128, generator(dev, 1))
    cpu_blocks = [type(b)(**{k: (v.cpu() if isinstance(v, torch.Tensor)
                                 else v) for k, v in vars(b).items()})
                  for b in batch.blocks]
    results = []
    for blocks, x, where in ((batch.blocks, ds.feat, dev),
                             (cpu_blocks, ds.feat.cpu(), None)):
        net = build_model(cfg, 32, 6)
        if where is not None:
            net.to(where)
        _build.LAUNCHES.reset()
        out = net(blocks, x)
        out.square().sum().backward()
        results.append([out.detach().cpu()]
                       + [p.grad.cpu() for p in net.parameters()])
        if where is not None:
            counts = _build.LAUNCHES.snapshot()
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    if model == "gcn":
        assert counts == {"pick_multiplicity": 3, "fanout_fwd": 3,
                          "fanout_bwd": 2}
    elif model == "pinsage":
        # layer 0's dst rows; the weighted sum at both layers; the prefix
        # form's backward at layer 1 (the feature table needs no gradient)
        assert counts == {"gather_rows": 1, "fanout_fwd": 2, "fanout_bwd": 1}
        assert float(batch.blocks[0].weights.sum()) > 0
    elif model == "mlp":
        assert counts == {"gather_rows": 1}
    else:
        assert counts == {"attend_fwd": 3, "attend_bwd": 3, "gather_rows": 1}


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_a_zoo_step_never_waits_on_the_card(dev, model):
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.train import train_step

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             dedup=False)
    cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                    calibration_batches=0, model=model, num_head=2)
    engine = Engine(ds, cfg).init()
    item = next(Shuffler(ds.train_set, cfg.batch_size).epoch_batches(0))
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


# ------------------------------------------------------ K8b weighted draws
def _weighted_csr(dev, fanout, seed):
    """Rows of degree 0, 1, around ``fanout``, past 128, a hub of 10,000
    entries, one of 70,000, and a skewed row (``4 * fanout + 3`` entries of
    two ids), with the port's alias and prefix tables and the coarse CDF."""
    from xgnn_tpu_torch.ops.sampling import build_coarse_cdf
    from xgnn_tpu_torch.synthetic import build_alias_tables
    from xgnn_tpu_torch.types import Graph

    rng = np.random.default_rng(seed)
    small = [0, 1, max(fanout - 1, 0), fanout, fanout + 1, 37, 128, 129, 300]
    degrees = np.concatenate([rng.choice(small, size=400),
                              [10_000, 70_000, 4 * fanout + 3]])
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, len(degrees), int(indptr[-1])).astype(np.int32)
    s = int(indptr[-2])
    indices[s:] = 7
    indices[s + 1] = 8
    ds = type("Host", (), dict(num_node=len(degrees),
                               num_edge=int(indptr[-1]), indptr=indptr,
                               indices=indices))()
    build_alias_tables(ds, seed=seed)
    g = Graph.from_dataset(ds, dev, weighted=True)
    assert torch.equal(g.coarse_cdf, build_coarse_cdf(
        g.indptr, g.prob_prefix_table, g.num_node))
    return g


def _weighted_frontier(dev, g, seed, b=3 * 256 + 77):
    f = torch.randint(0, g.num_node, (b,), generator=_gen(dev, seed),
                      device=dev, dtype=torch.int32)
    f[-3:] = torch.arange(g.num_node - 3, g.num_node, device=dev,
                          dtype=torch.int32)  # the hubs and the skewed row
    f[::9] = EMPTY
    f[1::11] = g.num_node + 3  # outside the contract: degree 0
    return f


def _edge_uniforms(dev, shape, seed):
    """uniforms with 0 and the float below 1 in them"""
    u = torch.rand(shape, generator=_gen(dev, seed), device=dev)
    u.view(-1)[::13] = 0.0
    u.view(-1)[5::11] = 1.0 - 2.0 ** -24
    return u


@pytest.mark.parametrize("fanout", [1, 5, 15, 32, 33, 64])
@pytest.mark.parametrize("coarse", [True, False])
def test_prefix_kernel_equals_plain(dev, fanout, coarse):
    """K8b-prefix over rows of degree 0, short rows, hubs of 10,000 and
    70,000 entries (searched through their coarse rows), EMPTY and ids
    past N, with and without the coarse CDF.  A warp takes a run of
    min(32, 512 // fanout) rows: the 845 rows are no multiple of it."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import (
        sample_weighted_khop_prefix,
        sample_weighted_khop_prefix_plain,
    )

    g = _weighted_csr(dev, fanout, fanout)
    f = _weighted_frontier(dev, g, fanout)
    cdf = g.coarse_cdf if coarse else None
    args = (g.indptr, g.indices, g.prob_prefix_table, f, fanout)
    _build.LAUNCHES.reset()
    for seed in range(5):
        u = _edge_uniforms(dev, (f.shape[0], fanout), 100 + seed)
        ref = sample_weighted_khop_prefix_plain(*args, None, g.n_max_deg,
                                                cdf, u=u)
        out = sample_weighted_khop_prefix(*args, None, g.n_max_deg, cdf,
                                          u=u)
        assert torch.equal(out, ref), seed
    out = sample_weighted_khop_prefix(*args, _gen(dev, 5), coarse_cdf=cdf)
    assert torch.equal(out, sample_weighted_khop_prefix_plain(
        *args, _gen(dev, 5), g.n_max_deg, cdf))
    assert bool((out[-3:-1] != EMPTY).all())  # the hubs
    assert _build.LAUNCHES.snapshot() == {"sample_prefix": 6}
    assert sample_weighted_khop_prefix(g.indptr, g.indices,
                                       g.prob_prefix_table, f[:0],
                                       fanout).shape == (0, fanout)


@pytest.mark.parametrize("fanout", [1, 5, 15, 64])
@pytest.mark.parametrize("dedup", [False, True])
def test_alias_kernels_equal_plain(dev, fanout, dedup):
    """K8b-alias, weighted_khop and its hash-dedup form, over the same
    rows; the skewed row's draws hold fewer than ``fanout`` distinct
    values."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import sampling as s

    kernel, plain = ((s.sample_weighted_khop_hash_dedup,
                      s.sample_weighted_khop_hash_dedup_plain) if dedup
                     else (s.sample_weighted_khop, s.sample_weighted_khop_plain))
    g = _weighted_csr(dev, fanout, 50 + fanout)
    f = _weighted_frontier(dev, g, fanout)
    args = (g.indptr, g.indices, g.prob_table, g.alias_table, f, fanout)
    m = (s.HASH_DEDUP_ROUNDS if dedup else 1) * fanout
    _build.LAUNCHES.reset()
    for seed in range(5):
        u = _edge_uniforms(dev, (f.shape[0], m), 200 + seed)
        coin = _edge_uniforms(dev, (f.shape[0], m), 300 + seed)
        out = kernel(*args, u=u, coin=coin)
        assert torch.equal(out, plain(*args, u=u, coin=coin)), seed
    out = kernel(*args, _gen(dev, 5))
    assert torch.equal(out, plain(*args, _gen(dev, 5)))
    if dedup and fanout > 2:  # the skewed row: at most two distinct ids
        skewed = out[-1]
        kept = skewed[skewed != EMPTY].tolist()
        assert 7 in kept and set(kept) <= {7, 8}
        assert bool((skewed[len(kept):] == EMPTY).all())
    assert _build.LAUNCHES.snapshot() == {"sample_alias": 6}
    assert kernel(*args[:4], f[:0], fanout).shape == (0, fanout)


# the hash-dedup form's (fanout, rounds): 20 draws a row (the main path's
# layer 2), 33 (no warp's multiple), 60 (layer 0) and 256 (the most)
_DEDUP_DRAWS = [(5, 4), (11, 3), (15, 4), (64, 4)]


@pytest.mark.parametrize("fanout,rounds", _DEDUP_DRAWS)
@pytest.mark.parametrize("rows", [845, 30_000, 60_000])
def test_hash_dedup_kernel_equals_plain(dev, fanout, rounds, rows):
    """K8b-alias's hash-dedup form, its draws packed densely over a block's
    rows, bit-equal to its plain version at 20, 33, 60 and 256 draws a
    row: rows of degree 0, 1, K and K + 1, hubs of 10,000 and 70,000
    entries, a row of two ids, a row whose weight sits on one neighbour
    (one distinct value, then EMPTY), EMPTY and out-of-range ids.  845
    rows fill no whole block; at 20 draws 30,000 and 60,000 rows take 2
    and 4 draws a thread (the launch's choice on 132 SMs)."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import sampling as s

    g = _weighted_csr(dev, fanout, 70 + fanout)
    deg = (g.indptr[1:] - g.indptr[:-1]).cpu()
    assert {fanout, fanout + 1, 10_000, 70_000} <= set(deg.tolist())
    one = int(torch.nonzero(deg == 300)[0])  # its weight on one neighbour
    a, b = int(g.indptr[one]), int(g.indptr[one + 1])
    g.prob_table[a:b] = 0.0
    g.alias_table[a:b] = 5
    f = _weighted_frontier(dev, g, fanout + rows, b=rows)
    f[-4] = one
    f[0] = int(torch.nonzero(deg == fanout)[0])
    f[1] = int(torch.nonzero(deg == fanout + 1)[0])
    args = (g.indptr, g.indices, g.prob_table, g.alias_table, f, fanout)
    m = rounds * fanout
    _build.LAUNCHES.reset()
    for seed in range(2):
        u = _edge_uniforms(dev, (rows, m), 400 + seed)
        coin = _edge_uniforms(dev, (rows, m), 500 + seed)
        out = s.sample_weighted_khop_hash_dedup(*args, u=u, coin=coin,
                                                rounds=rounds)
        ref = s.sample_weighted_khop_hash_dedup_plain(*args, u=u, coin=coin,
                                                      rounds=rounds)
        assert torch.equal(out, ref), seed
        assert out[-4, 0] == 5 and bool((out[-4, 1:] == EMPTY).all())
    assert _build.LAUNCHES.snapshot() == {"sample_alias": 2}


@pytest.mark.parametrize("fanout,rounds", _DEDUP_DRAWS)
def test_hash_dedup_tiered_and_cold_equal_plain(dev, fanout, rounds):
    """The hash-dedup form on a tiered topology (cold rows read in place
    from mapped host memory, in the same launch) equal to its plain
    version and to the untiered kernel over the whole CSR; its cold form
    equal to the plain cold form; at 20, 33, 60 and 256 draws a row."""
    from xgnn_tpu_torch.ops import sampling as s

    g, hot, tier, n = _tiered_graph(dev)
    f = torch.from_numpy(_tiered_frontier(g, tier, n, fanout)).to(dev)
    m = rounds * fanout
    gen = _gen(dev, m)
    u = torch.rand((f.shape[0], m), generator=gen, device=dev)
    coin = torch.rand((f.shape[0], m), generator=gen, device=dev)
    kw = dict(u=u, coin=coin, rounds=rounds)
    got = s.sample_weighted_khop_hash_dedup(
        hot.indptr, hot.indices, hot.prob_table, hot.alias_table, f, fanout,
        tier=tier, **kw)
    ref = s.sample_weighted_khop_hash_dedup_plain(
        hot.indptr, hot.indices, hot.prob_table, hot.alias_table, f, fanout,
        tier=tier, **kw)
    whole = s.sample_weighted_khop_hash_dedup(
        g.indptr, g.indices, g.prob_table, g.alias_table, f, fanout, **kw)
    assert torch.equal(got, ref) and torch.equal(got, whole)
    cold = s.sample_cold("alias_dedup", tier, f, fanout, **kw)
    want = s.sample_cold_plain("alias_dedup", tier, f.cpu(), fanout,
                               u=u.cpu(), coin=coin.cpu(), rounds=rounds)
    assert torch.equal(cold.cpu(), want)
    is_cold = (f >= tier.num_cache_node) & (f < n)
    assert torch.equal(cold[is_cold], got[is_cold])
    tier.csr.close()


def test_weighted_kernels_refuse(dev):
    from xgnn_tpu_torch.ops import sampling as s

    g = _weighted_csr(dev, 5, 1)
    f = _weighted_frontier(dev, g, 1)
    alias = (g.indptr, g.indices, g.prob_table, g.alias_table, f)
    with pytest.raises(ValueError, match="fanout"):
        s.sample_weighted_khop(*alias, 65)
    with pytest.raises(ValueError, match="draws"):
        s.sample_weighted_khop_hash_dedup(*alias, 64, rounds=5)
    with pytest.raises(ValueError, match="different devices"):
        s.sample_weighted_khop(*alias[:4], f.cpu(), 5)
    with pytest.raises(ValueError, match="u must be"):
        s.sample_weighted_khop_hash_dedup(
            *alias, 5, u=torch.rand((f.shape[0], 5), device=dev),
            coin=torch.rand((f.shape[0], 5), device=dev))
    prefix = (g.indptr, g.indices, g.prob_prefix_table, f)
    with pytest.raises(ValueError, match="fanout"):
        s.sample_weighted_khop_prefix(*prefix, 65)
    with pytest.raises(ValueError, match="coarse_cdf"):
        s.sample_weighted_khop_prefix(*prefix, 5,
                                      coarse_cdf=g.coarse_cdf.cpu())


def test_a_weighted_step_never_waits_on_the_card(dev):
    """GraphSAGE on weighted_khop_prefix: the sampler's three K8b-prefix
    launches and the train step only queue work on the card."""
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.train import train_step

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             weighted=True, dedup=False)
    cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                    calibration_batches=0, sample_type="weighted_khop_prefix")
    engine = Engine(ds, cfg).init()
    item = next(Shuffler(ds.train_set, cfg.batch_size).epoch_batches(0))
    batch, x, labels, _, _ = engine._produce((item, 1, (0, 0)))
    train_step(engine.model, engine.opt, batch.blocks, x, labels,
               batch.num_output, generator(dev, 2), batch.overflow)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch, x, labels, _, _ = engine._produce((item, 3, (0, 1)))
        metrics = train_step(engine.model, engine.opt, batch.blocks, x,
                             labels, batch.num_output, generator(dev, 4),
                             batch.overflow)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.LAUNCHES.snapshot()["sample_prefix"] == 3
    assert np.isfinite(float(metrics["loss"]))


def _tiered_inputs(dev, width, pct, seed, n=5000, num_node=3000):
    from xgnn_tpu_torch.store import TieredFeatureSource

    g = _gen(torch.device("cpu"), seed)
    feat = torch.randn((num_node, width), generator=g)
    ranking = torch.randperm(num_node, generator=g).to(torch.int32)
    src = TieredFeatureSource(feat, ranking, pct, dev)
    ids = torch.randint(-5, num_node + 5, (n,), generator=g,
                        dtype=torch.int32)
    ids[torch.rand(n, generator=g) < 0.3] = EMPTY
    return src, feat, ids.to(dev)


@pytest.mark.parametrize("width", [1, 3, 4, 128, 131, 256])
@pytest.mark.parametrize("pct", [0.0, 0.3, 0.9])
@pytest.mark.parametrize("num_input", [0, 1, 2999, 5000])
def test_tiered_extract_kernel_equals_plain(dev, width, pct, num_input):
    """K11 against its plain version on the same tensors: rows bit-equal
    (zero for EMPTY, negative and out-of-range ids and past num_input),
    hit and miss counts equal, the split and the SMs' reads launched once
    each; the cache rows built by its all-miss form equal the host
    table's."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import tiered_extract_plain

    src, feat, ids = _tiered_inputs(dev, width, pct, width + num_input)
    assert src.host.dev_ptr is not None
    cached = (src.posmap != EMPTY).nonzero().flatten()
    assert torch.equal(src.cache_feat[src.posmap[cached].long()].cpu(),
                       feat[cached.cpu()])
    num = torch.tensor(num_input, dtype=torch.int32, device=dev)
    _build.LAUNCHES.reset()
    out, info = src.extract(ids, num)
    assert _build.LAUNCHES.snapshot() == {"tiered_split": 1,
                                          "tiered_direct": 1}
    ref, counts = tiered_extract_plain(ids, num, src.posmap, src.cache_feat,
                                       src.feat_host)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert [int(info["num_hit"]), int(info["num_miss"])] == counts.tolist()
    assert int(info["miss_bytes"]) == int(counts[1]) * width * 4
    if pct == 0.0:
        assert int(info["num_hit"]) == 0


@pytest.mark.parametrize("width", [3, 47, 128, 256])
@pytest.mark.parametrize("pct", [0.0, 0.3])
def test_tiered_extract_bf16_kernel_equals_plain(dev, width, pct):
    """K11 with a bfloat16 cache (feat_dtype="bfloat16"): the cache built
    by its all-miss form is the host rows rounded to bfloat16; an
    extract's rows (hits copied, misses read as float32 and rounded as the
    SMs write them) equal its plain version's, bit for bit, the counts
    equal, the miss bytes the host's float32."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import tiered_extract_plain
    from xgnn_tpu_torch.store import TieredFeatureSource

    g = _gen(torch.device("cpu"), width)
    num_node, n = 3000, 5000
    feat = torch.randn((num_node, width), generator=g)
    ranking = torch.randperm(num_node, generator=g).to(torch.int32)
    src = TieredFeatureSource(feat, ranking, pct, dev, torch.bfloat16)
    assert src.cache_feat.dtype == torch.bfloat16
    assert src.feat_host.dtype == torch.float32
    cached = (src.posmap != EMPTY).nonzero().flatten()
    assert torch.equal(src.cache_feat[src.posmap[cached].long()].cpu(),
                       feat[cached.cpu()].to(torch.bfloat16))
    ids = torch.randint(-5, num_node + 5, (n,), generator=g,
                        dtype=torch.int32)
    ids[torch.rand(n, generator=g) < 0.3] = EMPTY
    ids = ids.to(dev)
    num = torch.tensor(4000, dtype=torch.int32, device=dev)
    _build.LAUNCHES.reset()
    out, info = src.extract(ids, num)
    assert _build.LAUNCHES.snapshot() == {"tiered_split": 1,
                                          "tiered_direct_bf16": 1}
    ref, counts = tiered_extract_plain(ids, num, src.posmap, src.cache_feat,
                                       src.feat_host)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert [int(info["num_hit"]), int(info["num_miss"])] == counts.tolist()
    assert int(info["miss_bytes"]) == int(counts[1]) * width * 4


def test_tiered_extract_all_miss_form_on_the_card(dev):
    from xgnn_tpu_torch.ops.tiered import (
        MappedHostTable,
        tiered_extract,
        tiered_extract_plain,
    )

    feat = torch.randn((4000, 128), generator=_gen(torch.device("cpu"), 3))
    host = MappedHostTable(feat, dev)
    ids = torch.randperm(4000, generator=_gen(torch.device("cpu"), 4))[:1500]
    ids = ids.to(torch.int32).to(dev)
    out, counts = tiered_extract(ids, 1500, None, None, host)
    ref, ref_counts = tiered_extract_plain(ids, 1500, None, None, host.tensor)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(out.cpu(),
                                                 feat[ids.cpu().long()])
    assert counts.tolist() == ref_counts.tolist() == [0, 1500]
    host.close()
    assert host.dev_ptr is None
    with pytest.raises(ValueError, match="not mapped"):
        tiered_extract(ids, 1500, None, None, host)


def test_tiered_pinning_that_fails_raises(dev):
    """Pinning memory that is pinned already fails in CUDA, and raises; the
    error is not reported again by the next extract's launch check.  The
    range starts inside the table's registration, at an address that no
    registration starts at, so CUDA itself refuses it (the same range again
    is counted, not refused)."""
    from xgnn_tpu_torch.ops import tiered

    host = tiered.MappedHostTable(torch.ones((1000, 8)), dev)
    with pytest.raises(RuntimeError, match="pinning"):
        tiered._map(host.tensor[500:], dev.index)
    ids = torch.arange(1000, dtype=torch.int32, device=dev)
    out, counts = tiered.tiered_extract(ids, 1000, None, None, host)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), host.tensor)
    assert counts.tolist() == [0, 1000]
    host.close()


def _pass_rows(dev):
    """The misses that K11's SM reads take in one pass of their persistent
    grid (a quarter of the SMs, 8 warps a block, 8 rows a warp)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, sms // 4) * 8 * 8


def _miss_case(dev, case, width=128):
    """A mapped table, a posmap and cache over its first rows, and ids with
    as many misses as ``case`` says, counted in passes of the SMs' grid:
    ``(host, posmap, cache, ids, num_input)``."""
    from xgnn_tpu_torch.ops.tiered import MappedHostTable

    rows = _pass_rows(dev)
    misses = {"no_miss": 0, "one_row": 1, "one_pass": rows,
              "one_pass_plus_one": rows + 1, "all_miss": 3 * rows + 5,
              "many_passes": 52 * rows + 7, "empty": 0}[case]
    hits = 0 if case in ("all_miss", "empty") else 3000
    g = _gen(torch.device("cpu"), len(case))
    num_node = misses + hits + 1000
    feat = torch.randn((num_node, width), generator=g)
    host = MappedHostTable(feat, dev)
    num_cache = hits + 500
    posmap = torch.full((num_node,), EMPTY, dtype=torch.int32)
    posmap[:num_cache] = torch.randperm(num_cache, generator=g).to(
        torch.int32)
    cache = torch.empty((num_cache, width))
    cache[posmap[:num_cache].long()] = feat[:num_cache]
    picked = torch.cat([torch.arange(hits),
                        num_cache + torch.randperm(num_node - num_cache,
                                                   generator=g)[:misses]])
    if case == "empty":
        ids = torch.empty(0, dtype=torch.int32)
    else:
        ids = picked[torch.randperm(picked.numel(), generator=g)].to(
            torch.int32)
        # EMPTY, out-of-range and dead slots beside them
        ids = torch.cat([ids, torch.tensor([EMPTY, -1, num_node],
                                           dtype=torch.int32),
                         torch.randint(0, num_node, (50,), generator=g,
                                       dtype=torch.int32)])
    num_input = torch.tensor(ids.numel() - 50 * (ids.numel() > 0),
                             dtype=torch.int32, device=dev)
    if case == "all_miss":
        posmap = cache = None
    else:
        posmap, cache = posmap.to(dev), cache.to(dev)
    return host, posmap, cache, ids.to(dev), num_input


@pytest.mark.parametrize("case", ["no_miss", "one_row", "one_pass",
                                  "one_pass_plus_one", "all_miss",
                                  "many_passes", "empty"])
def test_tiered_split_direct_and_extract_equal_plain(dev, case):
    """K11's split (the hit and zero rows, the miss list, the counts), its
    SM reads of the misses and the whole extract bit-equal to their plain
    versions: no miss, one row, exactly one pass of the SMs' grid and one
    more row, the all-miss form, no ids, and over 50 passes; ``num_input``
    a device scalar, the miss count read on the device."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import (
        tiered_direct,
        tiered_direct_plain,
        tiered_extract,
        tiered_extract_plain,
        tiered_split,
        tiered_split_plain,
    )

    host, posmap, cache, ids, num = _miss_case(dev, case)
    out, counts, pos, miss_ids = tiered_split(ids, num, posmap, cache, host)
    p_out, p_counts, p_pos, p_ids = tiered_split_plain(ids, num, posmap,
                                                       cache, host.tensor)
    torch.cuda.synchronize()
    nm = int(p_counts[1])
    assert torch.equal(counts, p_counts)
    assert torch.equal(pos[:nm], p_pos[:nm])
    assert torch.equal(miss_ids[:nm], p_ids[:nm])
    kept = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
    kept[pos[:nm].long()] = False
    assert torch.equal(out[kept], p_out[kept])
    got = tiered_direct(p_out.clone(), p_ids, p_pos, p_counts, host)
    assert torch.equal(got, tiered_direct_plain(p_out.clone(), p_ids, p_pos,
                                                nm, host.tensor))
    _build.LAUNCHES.reset()
    out, counts = tiered_extract(ids, num, posmap, cache, host)
    ref, ref_counts = tiered_extract_plain(ids, num, posmap, cache,
                                           host.tensor)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(counts, ref_counts)
    assert _build.LAUNCHES.snapshot() == (
        {} if case == "empty" else {"tiered_split": 1, "tiered_direct": 1})
    host.close()


@pytest.mark.parametrize("num_input", [0, 700, 4096])
def test_accumulate_freq_kernel_equals_plain(dev, num_input):
    from xgnn_tpu_torch.ops.presample import (
        accumulate_freq,
        accumulate_freq_plain,
    )

    g = _gen(dev, num_input)
    ids = torch.randint(-3, 1003, (4096,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::7] = EMPTY
    freq = torch.randint(0, 9, (1000,), generator=g, device=dev,
                         dtype=torch.int32)
    num = torch.tensor(num_input, dtype=torch.int32, device=dev)
    want = accumulate_freq_plain(freq.clone(), ids, num)
    got = accumulate_freq(freq, ids, num)
    torch.cuda.synchronize()
    assert got is freq and torch.equal(got, want)


@pytest.mark.parametrize("num_layer", [0, 1, 2, 3])
def test_closure_expand_kernel_equals_plain(dev, num_layer):
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.ops.presample import (
        closure_expand,
        closure_expand_plain,
    )

    ds = make_device_dataset(20_001, 60_000, 4, 3, seed=num_layer,
                             device=dev, dedup=False)
    seeds = torch.from_numpy(ds.train_set[:300]).to(dev)
    seeds[::11] = EMPTY
    counts = torch.randint(0, 5, (ds.num_node,), generator=_gen(dev, 1),
                           device=dev, dtype=torch.int32)
    want = closure_expand_plain(ds.graph.indptr, ds.graph.indices, seeds,
                                num_layer, counts.clone())
    got = closure_expand(ds.graph.indptr, ds.graph.indices, seeds, num_layer,
                         counts)
    torch.cuda.synchronize()
    assert got is counts and torch.equal(got, want)


def _csr(dev, rows):
    """A CSR from a list of neighbour lists."""
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate([np.asarray(r, np.int64) for r in rows] +
                             [np.zeros(0, np.int64)])
    return (torch.from_numpy(indptr.astype(np.int32)).to(dev),
            torch.from_numpy(indices.astype(np.int32)).to(dev))


def _closure_graph(dev, case):
    """``(indptr, indices, seeds)`` of a K12b edge case."""
    rng = np.random.default_rng(len(case))
    if case == "star":
        # a hub of 12,345 neighbours (chunked), leaves pointing back and on
        n = 20_000
        rows = [list(range(1, 12_346))] + [[0, (v * 7) % n] for v in
                                           range(1, n)]
        return (*_csr(dev, rows), [5, 0])
    if case == "chain":
        n = 50
        return (*_csr(dev, [[v + 1] for v in range(n - 1)] + [[]]), [0])
    if case == "odd seeds":
        n = 3000
        rows = [list(rng.integers(0, n, rng.integers(0, 9))) for _ in
                range(n)]
        return (*_csr(dev, rows), [7, 7, EMPTY, n, n + 5, -1, -7, 2999, 7])
    if case == "self-loops and isolated":
        rows = [[0], [], [1, 1], [], [4, 0], [], [6]]
        return (*_csr(dev, rows + [[]] * 100), [0, 2, 4, 6, 3])
    if case == "fills at layer 1":
        n = 4096
        rows = [list(range(n))] + [[0]] * (n - 1)
        return (*_csr(dev, rows), [0])
    if case == "claims beside the frontier":
        # tile t: lanes 0-19 seeds, each to lanes 20-31 of tile t + 7; lanes
        # 20-31 to a far node, each far node to a farther one.  A tile whose
        # rows 20-31 were marked or claimed by this launch must not stream
        # them as if an earlier layer had expanded them.
        tiles = 2048
        far = tiles * 32
        rows = []
        for t in range(tiles):
            nxt = ((t + 7) % tiles) * 32
            rows += [[nxt + 20 + (k + j) % 12 for j in range(6)]
                     for k in range(20)]
            rows += [[far + t * 12 + k] for k in range(12)]
        rows += [[far + tiles * 12 + k] for k in range(tiles * 12)]
        rows += [[]] * (tiles * 12)
        seeds = [t * 32 + k for t in range(tiles) for k in range(20)]
        return (*_csr(dev, rows), seeds)
    if case == "odd targets":
        n = 500
        rows = [list(rng.integers(-3, n + 3, 40)) + [EMPTY] for _ in
                range(n)]
        return (*_csr(dev, rows), list(range(0, n, 50)))
    raise ValueError(case)


@pytest.mark.parametrize("case", ["star", "chain", "odd seeds",
                                  "self-loops and isolated",
                                  "fills at layer 1", "odd targets",
                                  "claims beside the frontier"])
@pytest.mark.parametrize("num_layer", [0, 1, 2, 3, 4])
def test_closure_expand_edge_cases(dev, case, num_layer):
    """Bit-equal to the plain version, added in place into counts that are
    not zero."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.presample import (
        closure_expand,
        closure_expand_plain,
    )

    indptr, indices, seeds = _closure_graph(dev, case)
    seeds = torch.tensor(seeds, dtype=torch.int32, device=dev)
    n = indptr.shape[0] - 1
    counts = torch.randint(0, 3, (n,), generator=_gen(dev, 2), device=dev,
                           dtype=torch.int32)
    want = closure_expand_plain(indptr, indices, seeds, num_layer,
                                counts.clone())
    _build.LAUNCHES.reset()
    got = closure_expand(indptr, indices, seeds, num_layer, counts)
    torch.cuda.synchronize()
    assert got is counts and torch.equal(got, want)
    assert _build.LAUNCHES.snapshot() == {"closure_expand": 1}
    if case == "chain":  # a row a layer
        marked = closure_expand_plain(indptr, indices, seeds, num_layer,
                                      torch.zeros_like(counts))
        assert int(marked.sum()) == num_layer + 1


def test_closure_expand_products_batch_launches(dev):
    """A products-sized batch (power-law graph, 200,003 nodes, 3 layers):
    exact, and L + 3 device records (a memset, the start, two layers below
    the last, the count and the last layer)."""
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.ops.presample import (
        closure_expand,
        closure_expand_plain,
    )

    ds = make_device_dataset(200_003, 2_500_000, 4, 3, seed=5, device=dev,
                             dedup=False)
    seeds = torch.from_numpy(ds.train_set[:800]).to(dev)
    zero = torch.zeros(ds.num_node, dtype=torch.int32, device=dev)
    want = closure_expand_plain(ds.graph.indptr, ds.graph.indices, seeds, 3,
                                zero.clone())
    got = closure_expand(ds.graph.indptr, ds.graph.indices, seeds, 3,
                         zero.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) > 100_000
    kernels, _ = _device_kernels(lambda: closure_expand(
        ds.graph.indptr, ds.graph.indices, seeds, 3, zero))
    names = [k for k in kernels if "closure" in k]
    assert len(names) == 5, kernels


@pytest.mark.parametrize("policy", ["pre_sample", "presample_static",
                                    "dynamic_cache"])
def test_a_cached_step_never_waits_on_the_card(dev, policy):
    """The tiered store's step (K12 for the dynamic cache, K11) and the
    train step only queue work on the card; two epochs train with finite
    losses and a hit rate in (0, 1], the dynamic cache refreshes, and rows
    extracted after it are the host table's."""
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.train import train_step

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             dedup=False)
    cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                    calibration_batches=1, cache_percentage=0.2,
                    cache_policy=policy)
    engine = Engine(ds, cfg).init()
    assert not engine._direct
    item = next(Shuffler(ds.train_set, cfg.batch_size).epoch_batches(0))
    batch, x, labels, _, _ = engine._produce((item, 1, (0, 0)))
    train_step(engine.model, engine.opt, batch.blocks, x, labels,
               batch.num_output, generator(dev, 2), batch.overflow)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch, x, labels, info, _ = engine._produce((item, 3, (0, 1)))
        metrics = train_step(engine.model, engine.opt, batch.blocks, x,
                             labels, batch.num_output, generator(dev, 4),
                             batch.overflow)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = _build.LAUNCHES.snapshot()
    assert counts["tiered_split"] == counts["tiered_direct"] == 1
    assert counts.get("accumulate_freq", 0) == (policy == "dynamic_cache")
    assert np.isfinite(float(metrics["loss"]))
    posmap = engine.feature_source.posmap.clone()
    for e in range(2):
        r = engine.train_epoch(e)
        assert np.isfinite(r["loss"]) and 0 < r["hit_rate"] <= 1
    changed = not torch.equal(engine.feature_source.posmap, posmap)
    assert changed == (policy == "dynamic_cache")
    ids = torch.arange(512, dtype=torch.int32, device=dev)
    out, _ = engine.feature_source.extract(ids, 512)
    assert torch.equal(out, ds.feat[:512])


# ----------------------------------------------- K6 full-graph aggregation
def _csr_with_hub(dev, seed, n=3000, hub_deg=9000):
    """Rows of degree 0 to 40, one row past HUB_CAP (2048) and one hub of
    ``hub_deg``, on the card."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, n)
    deg[rng.choice(n, 100, replace=False)] = 0
    deg[5], deg[n // 2] = 2049, hub_deg
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(indices).to(dev), deg)


def _agg_close(out, ref, mass, rtol=1e-5):
    """Within rtol of the aggregate of the terms' magnitudes: the error
    bound of a sum taken in another order."""
    return bool(((out - ref).abs() <= rtol * mass + 1e-7).all())


@pytest.mark.parametrize("width", [47, 128, 256])
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("hub_cap", [None, 0, 2**31 - 1])
def test_spmm_kernel_equals_plain(dev, width, mean, hub_cap, monkeypatch):
    """K6a against its plain version on the CPU: every row of at most
    HUB_CAP edges bit for bit (both sum in CSR order from 0), the hub rows
    within 1e-5 of the aggregate of |h|; the same bits on a second launch;
    one launch counted a call.  ``hub_cap`` 0 sends every row to the
    block-a-row kernel, 2^31 - 1 none."""
    from xgnn_tpu_torch.ops import _build, spmm

    if hub_cap is not None:
        monkeypatch.setattr(spmm, "HUB_CAP", hub_cap)
    indptr, indices, deg = _csr_with_hub(dev, width)
    n = indptr.shape[0] - 1
    h = torch.randn((n, width), generator=_gen(dev, width), device=dev)
    _build.LAUNCHES.reset()
    out = spmm.spmm_csr(indptr, indices, h, num_node=n, mean=mean)
    again = spmm.spmm_csr(indptr, indices, h, num_node=n, mean=mean)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == {"spmm_csr": 2}
    assert torch.equal(out, again)
    ref = spmm.spmm_csr_plain(indptr.cpu(), indices.cpu(), h.cpu(),
                              num_node=n, mean=mean)
    mass = spmm.spmm_csr_plain(indptr.cpu(), indices.cpu(), h.abs().cpu(),
                               num_node=n, mean=mean)
    cap = spmm.HUB_CAP
    short = torch.from_numpy(deg <= cap)
    assert torch.equal(out.cpu()[short], ref[short])
    assert _agg_close(out.cpu(), ref, mass)
    # and against the plain version on the card (index_add_'s atomics)
    assert _agg_close(out, spmm.spmm_csr_plain(indptr, indices, h,
                                               num_node=n, mean=mean),
                      mass.to(dev))
    # an unaligned view takes the 4-byte path
    sub = h[:, 1:]
    assert torch.equal(spmm.spmm_csr(indptr, indices, sub, num_node=n)
                       .cpu()[short],
                       spmm.spmm_csr_plain(indptr.cpu(), indices.cpu(),
                                           sub.cpu(), num_node=n)[short])


@pytest.mark.parametrize("heads,d", [(1, 47), (1, 256), (8, 32), (2, 4),
                                    (1, 1), (1, 33), (1, 63)])
@pytest.mark.parametrize("hub_cap", [None, 0])
def test_gat_kernel_equals_plain(dev, heads, d, hub_cap, monkeypatch):
    """K6b against its plain version (JAX's two passes) on the card and on
    the CPU, within 1e-5 of the softmax-weighted aggregate of |feat|; the
    same bits on a second launch; zero rows where a row is empty.  Widths
    1, 33 and 63 at one head take the lean scalar kernel around its
    slices' 32-float limits (a lane holds columns c and c + 32)."""
    from xgnn_tpu_torch.ops import _build, spmm

    if hub_cap is not None:
        monkeypatch.setattr(spmm, "HUB_CAP", hub_cap)
    indptr, indices, deg = _csr_with_hub(dev, heads * d, hub_deg=5000)
    n = indptr.shape[0] - 1
    g = _gen(dev, d)
    feat = torch.randn((n, heads, d), generator=g, device=dev)
    el = torch.randn((n, heads), generator=g, device=dev)
    er = 3 * torch.randn((n, heads), generator=g, device=dev)
    _build.LAUNCHES.reset()
    out = spmm.gat_aggregate_csr(indptr, indices, feat, el, er, num_node=n)
    again = spmm.gat_aggregate_csr(indptr, indices, feat, el, er, num_node=n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == {"gat_aggregate_csr": 2}
    assert torch.equal(out, again)
    mass = spmm.gat_aggregate_csr_plain(indptr, indices, feat.abs(), el, er,
                                        num_node=n)
    assert _agg_close(out, spmm.gat_aggregate_csr_plain(
        indptr, indices, feat, el, er, num_node=n), mass)
    cpu = [t.cpu() for t in (indptr, indices, feat, el, er)]
    assert _agg_close(out.cpu(), spmm.gat_aggregate_csr_plain(
        *cpu, num_node=n), mass.cpu())
    assert not out[torch.from_numpy(deg == 0).to(dev)].any()


def test_prefix_and_gat_kernels_on_rows_of_127_to_129_entries(dev):
    """K8b-prefix reads a row of at most 128 entries whole and a longer one
    through its coarse row; K6b takes a row's edges 32 at a time.  Both on
    rows of 127, 128 and 129 entries (and of 0, 1, 32 and 33), exact (K8b)
    and within 1e-5 of the weighted aggregate of |feat| (K6b)."""
    from xgnn_tpu_torch.ops import sampling, spmm
    from xgnn_tpu_torch.ops.sampling import build_coarse_cdf
    from xgnn_tpu_torch.synthetic import build_alias_tables
    from xgnn_tpu_torch.types import Graph

    degrees = np.array([127, 128, 129, 0, 1, 32, 33] * 40)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    rng = np.random.default_rng(127)
    indices = rng.integers(0, len(degrees), int(indptr[-1])).astype(np.int32)
    ds = type("Host", (), dict(num_node=len(degrees),
                               num_edge=int(indptr[-1]), indptr=indptr,
                               indices=indices))()
    build_alias_tables(ds, seed=3)
    g = Graph.from_dataset(ds, dev, weighted=True)
    cdf = build_coarse_cdf(g.indptr, g.prob_prefix_table, g.num_node)
    f = torch.arange(g.num_node, device=dev, dtype=torch.int32)
    for fanout in (5, 33):
        args = (g.indptr, g.indices, g.prob_prefix_table, f, fanout, None,
                g.n_max_deg)
        for seed, coarse in ((1, cdf), (2, None)):
            u = _edge_uniforms(dev, (f.shape[0], fanout), seed)
            assert torch.equal(
                sampling.sample_weighted_khop_prefix(*args, coarse, u=u),
                sampling.sample_weighted_khop_prefix_plain(*args, coarse,
                                                           u=u))
    n = g.num_node
    for heads, d in ((1, 47), (1, 256), (8, 32)):
        gen = _gen(dev, d)
        feat = torch.randn((n, heads, d), generator=gen, device=dev)
        el = torch.randn((n, heads), generator=gen, device=dev)
        er = 3 * torch.randn((n, heads), generator=gen, device=dev)
        out = spmm.gat_aggregate_csr(g.indptr, g.indices, feat, el, er,
                                     num_node=n)
        ref = spmm.gat_aggregate_csr_plain(g.indptr, g.indices, feat, el, er,
                                           num_node=n)
        mass = spmm.gat_aggregate_csr_plain(g.indptr, g.indices, feat.abs(),
                                            el, er, num_node=n)
        assert _agg_close(out, ref, mass), (heads, d)
        assert not out[torch.from_numpy(degrees == 0).to(dev)].any()


@pytest.mark.parametrize("conv,heads", [("graphsage", 1), ("gcn", 1),
                                        ("gat", 8), ("pinsage", 1)])
def test_full_graph_inference_never_waits_on_the_card(dev, conv, heads):
    """The layers launch K6 once each and nothing in them waits on the
    host; the logits agree with the CPU's."""
    from xgnn_tpu_torch.inference import full_graph_inference
    from xgnn_tpu_torch.models.gnn import GNN
    from xgnn_tpu_torch.ops import _build

    indptr, indices, _ = _csr_with_hub(dev, 7)
    n = indptr.shape[0] - 1
    feat = torch.randn((n, 32), generator=_gen(dev, 8), device=dev)
    model = GNN(32, 64, 6, 3, conv=conv, num_heads=heads)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ref = full_graph_inference(model, indptr.cpu(), indices.cpu(),
                               feat.cpu(), device="cpu")
    model.to(dev)
    full_graph_inference(model, indptr, indices, feat)  # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = full_graph_inference(model, indptr, indices, feat)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    name = "gat_aggregate_csr" if conv == "gat" else "spmm_csr"
    assert _build.LAUNCHES.snapshot() == {name: 3}
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- CUDA graphs (device_loop)
# Each capture test runs in a Python process of its own, so that no other
# test of this file runs after a CUDA graph in its process, whatever the
# order of the tests: the profiler-based tests count kernel records, and
# after a replay in the process a profiler session had lost some (seen on
# an H100 with torch 2.11 and CUDA 12.8).


def _in_own_process(body: str, *args):
    """Runs ``body(dev, *args)``, a function of this module, in a new Python
    process on card 0."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, torch\n"
            f"sys.path.insert(0, {tests!r})\n"
            "import test_torch_port_cuda as m\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            f"m.{body}(torch.device('cuda', 0), *{args!r})\n")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=os.path.dirname(tests), capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-6000:] + r.stderr[-6000:]


def _unique_replayed_under_capture(dev):
    from xgnn_tpu_torch.ops import unique

    rng = np.random.default_rng(12)
    num_node, cap = 200_000, 60_000
    cases = [_dedup_inputs(rng, num_node, 5000, 4700, 50_000)
             for _ in range(4)]
    prefix, picks, num_prev = _on_card(dev, cases[0])
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        # the state made, and the kernels loaded, before the capture
        unique.unique_seeded_split(prefix, picks, num_prev, cap,
                                   num_node=num_node)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = unique.unique_seeded_split(prefix, picks, num_prev, cap,
                                         num_node=num_node)
    st = unique._states[(dev.index, stream.cuda_stream, num_node)]
    gen = st.gen
    for i, case in enumerate(cases[1:]):
        for buf, val in zip((prefix, picks, num_prev), _on_card(dev, case)):
            buf.copy_(val)
        graph.replay()
        torch.cuda.synchronize()
        _assert_plain(out, (prefix, picks, num_prev), cap)
        assert st.gen == gen + i + 1


def test_unique_replayed_under_capture(dev):
    """K3 captured once in a CUDA graph, replayed three times with new picks
    copied into its inputs: each replay equals the plain version, so the
    generation advances on the card, not in the captured launch."""
    _in_own_process("_unique_replayed_under_capture")


def _pick_multiplicity_replayed_under_capture(dev):
    from xgnn_tpu_torch.ops import degree

    g = _gen(dev, 21)
    ids = torch.randint(0, 50_000, (133_376, 10), generator=g, device=dev,
                        dtype=torch.int32)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        degree.pick_multiplicity(ids, 60_000)  # loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        cnt, w = degree.pick_multiplicity(ids, 60_000)
    for i in range(3):
        ids.copy_(torch.randint(0, 50_000 // (i + 1), ids.shape, generator=g,
                                device=dev, dtype=torch.int32))
        ids[::7] = EMPTY
        graph.replay()
        torch.cuda.synchronize()
        ref, ref_w = degree.pick_multiplicity_plain(ids, 60_000)
        assert torch.equal(cnt, ref) and torch.equal(w, ref_w)


def test_pick_multiplicity_replayed_under_capture(dev):
    """K7's three launches (the memset of the bins, the count and the
    gather) captured once in a CUDA graph, as gcn's device_loop captures
    them, replayed three times with new picks copied into its input: each
    replay equals the plain version."""
    _in_own_process("_pick_multiplicity_replayed_under_capture")


def _registered_generator_reseeded(dev):
    from xgnn_tpu_torch.device import generator

    gen = torch.Generator(device=dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        torch.rand((1000, 7), generator=gen, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=stream):
        a = torch.rand((1000, 7), generator=gen, device=dev)
        b = torch.rand((3, 1_000_003), generator=gen, device=dev)
    for seed in (3, 99, 3):
        gen.manual_seed(seed)
        graph.replay()
        torch.cuda.synchronize()
        ref = generator(dev, seed)
        assert torch.equal(a, torch.rand((1000, 7), generator=ref,
                                         device=dev))
        assert torch.equal(b, torch.rand((3, 1_000_003), generator=ref,
                                         device=dev))


def test_registered_generator_reseeded_equals_eager(dev):
    """A generator registered with a CUDA graph and seeded with
    ``manual_seed`` before each replay draws what a new generator of that
    seed draws eagerly (the device_loop's uniforms and dropout masks)."""
    _in_own_process("_registered_generator_reseeded")


def _hand_kernel_launches(engine, epoch) -> dict:
    """The port's kernels launched in one more epoch, by name, from the
    profiler's records."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "xgnn_tpu_torch", "csrc")
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names.update(decl.findall(fh.read()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # after a replay a session lost its first kernels' records: a
        # lead-in of spin kernels, not counted
        for _ in range(16):
            torch.cuda._sleep(1000)
        _settle()
        engine.train_epoch(epoch)
        _settle()
    counts = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n = re.sub(r"^void\s+", "",
                   e.name.replace("(anonymous namespace)::", ""))
        n = re.match(r"(?:\w+::)*(\w+)", n).group(1)
        if n in names:
            counts[n] = counts.get(n, 0) + 1
    return counts


def _device_loop_against_host_loop(dev, model, heads, options=None):
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.ops import _build

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev,
                             dedup=False)
    hist, counts = [], []
    for device_loop in (False, True):
        cfg = RunConfig(batch_size=256, fanout=(10, 5, 3), num_hidden=32,
                        model=model, num_head=heads, dropout=0.5,
                        calibration_batches=2, device_loop=device_loop,
                        **(options or {}))
        engine = Engine(ds, cfg).init()
        for epoch in range(2):
            _build.LAUNCHES.reset()
            engine.train_epoch(epoch)
            torch.cuda.synchronize()
            counts.append(_build.LAUNCHES.snapshot())
        if device_loop:
            assert engine._fused is not None and engine._fused.graph
        hist.append([engine.history[e] for e in range(2)])
    for host, fused in zip(*hist):
        assert np.all(np.isfinite(host["loss"]))
        np.testing.assert_allclose(fused["loss"], host["loss"], rtol=1e-5)
        np.testing.assert_allclose(fused["acc"], host["acc"], rtol=1e-5)
    # the capturing epoch calls each wrapper for the eager warm-up step and
    # the captured one; a replayed epoch calls none
    steps = len(hist[0][0]["loss"])
    assert counts[2] == {k: 2 * n // steps for k, n in counts[1].items()}
    assert counts[3] == {}
    # and its replays launch the eager steps' kernels: a profiled host-loop
    # epoch and a profiled replayed one of the same engine, a pair measured
    # again where the profiler dropped a record
    for attempt in range(3):
        engine.config.device_loop = False
        eager = _hand_kernel_launches(engine, 2 + 2 * attempt)
        engine.config.device_loop = True
        replayed = _hand_kernel_launches(engine, 3 + 2 * attempt)
        if eager and replayed == eager:
            break
    else:
        pytest.fail(f"replays launched {replayed}, eager steps {eager}")


@pytest.mark.parametrize("model,heads", [("graphsage", 1), ("gcn", 1),
                                         ("gat", 1), ("pinsage", 1)])
def test_device_loop_equals_the_host_loop_on_the_card(dev, model, heads):
    """Two epochs of the captured step, replayed, against the pipelined
    host loop from the same seeds at dropout 0.5: equal per-step losses and
    accuracies, and a profiled epoch of replays launches the hand kernels
    that as many eager steps launch."""
    _in_own_process("_device_loop_against_host_loop", model, heads)


@pytest.mark.parametrize("options", [
    dict(feat_dtype="bfloat16", compute_dtype="bfloat16"),
    dict(remat=True),
    dict(weight_decay=5e-4, agg_impl="tiled"),
], ids=["bf16", "remat", "adamw-tiled"])
def test_device_loop_with_training_options_equals_the_host_loop(dev,
                                                                options):
    """The training options captured and replayed (graphsage): per-step
    losses equal to the host loop's, and the replays launch the eager
    steps' hand kernels (remat's recomputed forwards in the backward of
    the captured step)."""
    _in_own_process("_device_loop_against_host_loop", "graphsage", 1,
                    options)


# ------------------------------------------------------- tiered topology
def _tiered_graph(dev, pct=0.5):
    """A weighted power-law graph on the card (alias tables built there)
    and its tiered topology at ``pct``: the hot prefix on the card, the
    whole CSR and tables pinned and mapped."""
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.synthetic_device import alias_tables, edge_weights

    ds = make_device_dataset(20_000, 300_000, 8, 5, seed=4, device=dev,
                             weighted=True, dedup=False)
    g = ds.graph
    g.prob_table, g.alias_table = alias_tables(
        g.indptr, g.indices, edge_weights(g.num_edge, 4, dev))
    hot, tier, n = make_tiered_topology(
        g.indptr, g.indices, pct, SampleType.WEIGHTED_KHOP,
        prob_table=g.prob_table, alias_table=g.alias_table,
        prob_prefix_table=g.prob_prefix_table, device=dev)
    return g, hot, tier, n


# cold-row degrees that the tiered kernels branch on: 0, 1, K - 1 for K =
# 5, 7, 10 and 15, a warp's 32 and 33, K2's whole row (64, 65), K8b-prefix's
# whole row (127, 128) and its coarse row (129), and a longer hub
_LAYOUT_DEGREES = (0, 1, 4, 6, 9, 14, 32, 33, 50, 64, 65, 127, 128, 129, 300)
# the frontier layouts of _tiered_frontier besides "mixed"
_LAYOUTS = ("all_cold", "all_hot", "one_cold_a_block", "cold_runs",
            "degrees", "block_edges")


def _layout_graph(dev, pct=0.5):
    """A weighted graph of 6,000 nodes whose degrees are drawn from
    _LAYOUT_DEGREES, its tables built on the card, and its tiered topology
    at ``pct``."""
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.ops.sampling import build_coarse_cdf
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.synthetic_device import (
        alias_tables,
        edge_weights,
        prefix_table,
    )
    from xgnn_tpu_torch.types import Graph

    rng = np.random.default_rng(12)
    n = 6000
    deg = rng.choice(_LAYOUT_DEGREES, n)
    indptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)).to(dev)
    indices = torch.from_numpy(rng.integers(
        0, n, int(deg.sum())).astype(np.int32)).to(dev)
    w = edge_weights(indices.numel(), 12, dev)
    g = Graph(indptr=indptr, indices=indices,
              prob_prefix_table=prefix_table(indptr, w),
              n_max_deg=int(deg.max()))
    g.prob_table, g.alias_table = alias_tables(indptr, indices, w)
    g.coarse_cdf = build_coarse_cdf(indptr, g.prob_prefix_table, n)
    hot, tier, n = make_tiered_topology(
        indptr, indices, pct, SampleType.WEIGHTED_KHOP,
        prob_table=g.prob_table, alias_table=g.alias_table,
        prob_prefix_table=g.prob_prefix_table, device=dev)
    return g, hot, tier, n


def _tiered_frontier(g, tier, n, seed, layout="mixed"):
    """Frontier ids for a tiered call.  "mixed": random ids, the 64 largest
    rows, EMPTY, and the prefix's edges.  The layouts that the cold-row
    designs create (_LAYOUTS): "all_cold", "all_hot", "one_cold_a_block"
    (a cold row in each 256-row block), "cold_runs" (a whole block cold,
    and 100 cold rows in a row: more than a warp's lanes), "degrees" (cold
    rows of every degree the graph's cold rows have, six of each, among hot
    rows), "block_edges" (cold rows on both sides of each block boundary
    and in a partial last block); every one but "all_cold" and "all_hot"
    with EMPTY, negative and out-of-range ids among its rows."""
    rng = np.random.default_rng(seed)
    ncn = tier.num_cache_node
    deg = (g.indptr[1:] - g.indptr[:-1]).cpu().numpy()
    if layout == "mixed":
        f = np.concatenate([rng.integers(0, n, 6000), np.argsort(-deg)[:64],
                            np.full(100, EMPTY), [n - 1, ncn, ncn - 1, 0]])
        f = f.astype(np.int32)
        rng.shuffle(f)
        cold = (f != EMPTY) & (f >= ncn)
        assert cold.sum() > 1000
        # cold rows past 128 entries: K8b-prefix's hubs, read in place
        assert (cold & (deg[np.minimum(f, n - 1)] > 128)).any()
        return f

    def hot(m):
        return rng.integers(0, ncn, m)

    def cold(m):
        return rng.integers(ncn, n, m)

    if layout == "all_cold":
        return cold(3000).astype(np.int32)
    if layout == "all_hot":
        return hot(3000).astype(np.int32)
    if layout == "one_cold_a_block":
        f = hot(256 * 12)
        f[np.arange(12) * 256 + rng.integers(0, 256, 12)] = cold(12)
    elif layout == "cold_runs":
        f = hot(256 * 6)
        f[256:512] = cold(256)
        f[800:900] = cold(100)
    elif layout == "degrees":
        ids = np.arange(ncn, n)
        have = np.unique(deg[ids])
        assert {0, 1, 128, 129} <= set(have.tolist())
        f = np.concatenate([rng.choice(ids[deg[ids] == d], 6) for d in have]
                           + [hot(200)])
        rng.shuffle(f)
    else:
        assert layout == "block_edges"
        f = hot(256 * 5 + 37)
        f[[0, 255, 256, 511, 512, 1023, 1024, 1279, 1280, 1300, 1316]] = (
            cold(11))
    junk = np.array([EMPTY, -1, -7, n, n + 5, EMPTY])
    at = rng.choice(f.size, junk.size, replace=False)
    f[at] = junk
    return f.astype(np.int32)


def _tiered_cases(dev, g, hot, tier, frontier, k, seed, walk_shape=(4, 3)):
    """Each tiered wrapper as ``fn(tier, graph)``, with its plain version
    on the tier, at the same uniforms (the walk's W and L
    ``walk_shape``)."""
    from xgnn_tpu_torch.ops import random_walk as rw
    from xgnn_tpu_torch.ops import sampling as s

    b = frontier.shape[0]
    gen = _gen(dev, seed)
    u = torch.rand((b, k), generator=gen, device=dev)
    coin = torch.rand((b, k), generator=gen, device=dev)
    m = s.HASH_DEDUP_ROUNDS * k
    um = torch.rand((b, m), generator=gen, device=dev)
    cm = torch.rand((b, m), generator=gen, device=dev)
    w, l = walk_shape
    uw = rw.draw_uniforms(w, l, b, gen, dev)
    walk = dict(num_random_walk=w, random_walk_length=l, restart_prob=0.5)
    kw = min(k, w * l)
    return {
        "sample_khop": lambda t, gr, f=s.sample_khop0: f(
            gr.indptr, gr.indices, frontier, k, u=u, tier=t),
        "sample_wr": lambda t, gr, f=s.sample_uniform_wr: f(
            gr.indptr, gr.indices, frontier, k, u=u, tier=t),
        "sample_wr khop1": lambda t, gr, f=s.sample_khop1: f(
            gr.indptr, gr.indices, frontier, k, u=u, tier=t),
        "sample_alias": lambda t, gr, f=s.sample_weighted_khop: f(
            gr.indptr, gr.indices, gr.prob_table, gr.alias_table, frontier,
            k, u=u, coin=coin, tier=t),
        "sample_alias dedup": lambda t, gr, f=(
            s.sample_weighted_khop_hash_dedup): f(
            gr.indptr, gr.indices, gr.prob_table, gr.alias_table, frontier,
            k, u=um, coin=cm, tier=t),
        "sample_prefix": lambda t, gr, f=s.sample_weighted_khop_prefix: f(
            gr.indptr, gr.indices, gr.prob_prefix_table, frontier, k,
            max_deg=gr.n_max_deg, coarse_cdf=gr.coarse_cdf, u=u, tier=t),
        "random_walk": lambda t, gr, f=rw.sample_random_walk: f(
            gr.indptr, gr.indices, frontier, kw, u=uw, tier=t, **walk),
    }, {
        "sample_khop": lambda: s.sample_khop0_plain(
            hot.indptr, hot.indices, frontier, k, u=u, tier=tier),
        "sample_wr": lambda: s.sample_uniform_wr_plain(
            hot.indptr, hot.indices, frontier, k, u=u, tier=tier),
        "sample_wr khop1": lambda: s.sample_khop1_plain(
            hot.indptr, hot.indices, frontier, k, u=u, tier=tier),
        "sample_alias": lambda: s.sample_weighted_khop_plain(
            hot.indptr, hot.indices, hot.prob_table, hot.alias_table,
            frontier, k, u=u, coin=coin, tier=tier),
        "sample_alias dedup": lambda: (
            s.sample_weighted_khop_hash_dedup_plain(
                hot.indptr, hot.indices, hot.prob_table, hot.alias_table,
                frontier, k, u=um, coin=cm, tier=tier)),
        "sample_prefix": lambda: s.sample_weighted_khop_prefix_plain(
            hot.indptr, hot.indices, hot.prob_prefix_table, frontier, k,
            max_deg=hot.n_max_deg, coarse_cdf=hot.coarse_cdf, u=u,
            tier=tier),
        "random_walk": lambda: rw.sample_random_walk_plain(
            hot.indptr, hot.indices, frontier, kw, u=uw, tier=tier, **walk),
    }


@pytest.mark.parametrize("k", [5, 10, 15, 7, 33])
def test_tiered_kernels_equal_plain_and_untiered(dev, k):
    """K2, K8a, K8b (its three forms) and K9 on a tiered topology, one
    launch over hot, cold and EMPTY rows: equal to their plain versions
    (the cold rows read from the host CSR on the CPU) and to the untiered
    kernels over the whole CSR on the card at the same uniforms."""
    g, hot, tier, n = _tiered_graph(dev)
    assert 0 < tier.num_cache_node < n
    assert hot.coarse_cdf.shape[0] == tier.num_cache_node
    frontier = torch.from_numpy(_tiered_frontier(g, tier, n, k)).to(dev)
    _assert_tiered_equal(dev, g, hot, tier, frontier, k)
    tier.csr.close()


def _assert_tiered_equal(dev, g, hot, tier, frontier, k):
    """Each tiered wrapper, counted once a call, equal to its plain version
    and to the untiered kernel over the whole CSR ``g``."""
    from xgnn_tpu_torch.ops import _build

    fns, plains = _tiered_cases(dev, g, hot, tier, frontier, k, k)
    for name, fn in fns.items():
        _build.LAUNCHES.reset()
        got = fn(tier, hot)
        torch.cuda.synchronize()
        assert _build.LAUNCHES.snapshot() == {name.split()[0]: 1}, name
        whole = fn(None, g)
        ref = plains[name]()
        if name == "random_walk":
            for a, b_, c in zip(got, whole, ref):
                assert torch.equal(a, b_) and torch.equal(a, c), name
        else:
            assert torch.equal(got, ref), name
            assert torch.equal(got, whole), name


@pytest.mark.parametrize("k", [5, 10, 15, 7])
@pytest.mark.parametrize("layout", _LAYOUTS)
def test_tiered_layouts_equal_plain_and_untiered(dev, layout, k):
    """The layouts of cold rows that K2's cold warps and K8b-prefix's cold
    ring meet (all cold, all hot, a cold row a block, more cold rows in a
    block than a warp has lanes, every cold degree from 0 to 300 with 128
    and 129 among them, cold rows at block boundaries and in a partial last
    block, EMPTY and out-of-range ids among them): every tiered sampler
    equal to its plain version and to the untiered kernel over the whole
    CSR, at K2's staged fanouts and an unstaged one."""
    g, hot, tier, n = _layout_graph(dev)
    frontier = torch.from_numpy(
        _tiered_frontier(g, tier, n, k, layout)).to(dev)
    _assert_tiered_equal(dev, g, hot, tier, frontier, k)
    tier.csr.close()


def _cold_ids_of(g, tier, n, rng, degree, m):
    """m cold ids of the given degree (some must exist)."""
    deg = (g.indptr[1:] - g.indptr[:-1]).cpu().numpy()
    ids = np.arange(tier.num_cache_node, n)
    ids = ids[deg[ids] == degree]
    assert ids.size, degree
    return rng.choice(ids, m)


@pytest.mark.parametrize("k", [5, 10, 15, 7, 33])
def test_tiered_wr_cold_rows_equal_plain_and_untiered(dev, k):
    """K8a (uniform_wr and khop1) on the cold rows its warp routine meets:
    cold rows of degree 0, 1 and K - 1; rows where every draw repeats (a
    row of degree 1, and cold rows whose K uniforms are equal); a warp
    whose 32 rows are all cold and a whole cold block (at K = 15 staged,
    at K = 7 and 33 the unstaged kernel); EMPTY and out-of-range ids.
    Equal to the plain version and to the untiered kernel over the whole
    CSR at the same uniforms."""
    from xgnn_tpu_torch.ops import sampling as s

    g, hot, tier, n = _layout_graph(dev)
    ncn = tier.num_cache_node
    rng = np.random.default_rng(k)
    f = rng.integers(0, ncn, 256 * 4 + 19)
    f[:32] = rng.integers(ncn, n, 32)  # a cold warp
    f[256:512] = rng.integers(ncn, n, 256)  # a cold block
    for at, d in ((600, 0), (606, 1), (612, k - 1)):
        f[at:at + 6] = _cold_ids_of(g, tier, n, rng, d, 6)
    f[700:720] = rng.integers(ncn, n, 20)
    f[[3, 40, 650, 1030]] = [EMPTY, -1, n, n + 7]
    frontier = torch.from_numpy(f.astype(np.int32)).to(dev)
    u = torch.rand((f.size, k), generator=_gen(dev, k), device=dev)
    u[700:720] = u[700:720, :1]  # every draw of these rows repeats
    for fn, plain in ((s.sample_uniform_wr, s.sample_uniform_wr_plain),
                      (s.sample_khop1, s.sample_khop1_plain)):
        got = fn(hot.indptr, hot.indices, frontier, k, u=u, tier=tier)
        ref = plain(hot.indptr, hot.indices, frontier, k, u=u, tier=tier)
        whole = fn(g.indptr, g.indices, frontier, k, u=u)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), fn.__name__
        assert torch.equal(got, whole), fn.__name__
    tier.csr.close()


@pytest.mark.parametrize("w,l,restart", [(4, 3, 0.0), (4, 3, 1.0),
                                         (4, 3, 0.5), (3, 5, 0.5),
                                         (1, 2, 0.5), (8, 8, 0.3)])
def test_tiered_walk_cold_seeds_equal_plain_and_untiered(dev, w, l, restart):
    """K9 on the cold walks its warp design meets: restart 0 and 1, a
    frontier that repeats one cold seed across warps, cold seeds of degree
    0, cold seeds whose neighbours are all cold (walks that stay on cold
    nodes other than the seed), a run of cold seeds, EMPTY and
    out-of-range ids, at the bench's (W, L) = (4, 3) and at run-time ones
    (W = 3: a seed's walkers across two warps).  Equal to the plain version
    and to the untiered walk over the whole CSR at the same uniforms."""
    from xgnn_tpu_torch.ops import random_walk as rw

    g, hot, tier, n = _layout_graph(dev)
    ncn = tier.num_cache_node
    indptr, indices = g.indptr.cpu().numpy(), g.indices.cpu().numpy()
    inner = [v for v in range(ncn, n) if indptr[v + 1] > indptr[v]
             and (indices[indptr[v]:indptr[v + 1]] >= ncn).all()]
    assert len(inner) >= 8
    rng = np.random.default_rng(w * 100 + l)
    f = rng.integers(0, n, 700)
    f[:70] = rng.integers(ncn, n)  # one cold seed again and again
    f[100:106] = _cold_ids_of(g, tier, n, rng, 0, 6)
    f[110:150] = rng.choice(inner, 40)
    f[200:300] = rng.integers(ncn, n, 100)
    f[[7, 90, 410, 699]] = [EMPTY, -2, n, n + 3]
    frontier = torch.from_numpy(f.astype(np.int32)).to(dev)
    uw = rw.draw_uniforms(w, l, f.size, _gen(dev, w + l), dev)
    kw = min(5, w * l)
    walk = dict(num_random_walk=w, random_walk_length=l,
                restart_prob=restart)
    got = rw.sample_random_walk(hot.indptr, hot.indices, frontier, kw, u=uw,
                                tier=tier, **walk)
    ref = rw.sample_random_walk_plain(hot.indptr, hot.indices, frontier, kw,
                                      u=uw, tier=tier, **walk)
    whole = rw.sample_random_walk(g.indptr, g.indices, frontier, kw, u=uw,
                                  **walk)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, whole):
        assert torch.equal(a, b) and torch.equal(a, c)
    tier.csr.close()


def test_tiered_kernels_refuse_an_unmapped_tier(dev):
    """A tier whose host CSR is not mapped for the card raises, and so
    does one whose hot prefix is not the device graph's."""
    from xgnn_tpu_torch.ops.sampling import sample_khop0
    from xgnn_tpu_torch.store.topology import MappedHostCSR, Tier

    g, hot, tier, n = _tiered_graph(dev)
    frontier = torch.arange(100, dtype=torch.int32, device=dev)
    cpu = Tier(tier.num_cache_node,
               MappedHostCSR(g.indptr, g.indices, device="cpu"))
    with pytest.raises(ValueError, match="not mapped"):
        sample_khop0(hot.indptr, hot.indices, frontier, 5, tier=cpu)
    with pytest.raises(ValueError, match="hot rows"):
        sample_khop0(g.indptr, g.indices, frontier, 5, tier=tier)
    tier.csr.close()


def _tiered_replayed_under_capture(dev):
    g, hot, tier, n = _tiered_graph(dev)
    f0 = torch.from_numpy(_tiered_frontier(g, tier, n, 1)).to(dev)
    frontier = f0.clone()
    # K8a's staged and unstaged kernels; the walk at (4, 3) and at a
    # run-time (W, L) whose seeds' walkers cross warps
    for k, walk_shape in ((10, (4, 3)), (33, (3, 5))):
        fns, plains = _tiered_cases(dev, g, hot, tier, frontier, k, 3,
                                    walk_shape)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for fn in fns.values():  # every library loaded before capture
                fn(tier, hot)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = {name: fn(tier, hot) for name, fn in fns.items()}
        for seed in (2, 5, 9):
            frontier.copy_(torch.from_numpy(
                _tiered_frontier(g, tier, n, seed)).to(dev))
            graph.replay()
            torch.cuda.synchronize()
            for name, out in outs.items():
                ref = plains[name]()
                if name == "random_walk":
                    assert all(torch.equal(a, b)
                               for a, b in zip(out, ref)), name
                else:
                    assert torch.equal(out, ref), name
        frontier.copy_(f0)


def test_tiered_kernels_replayed_under_capture(dev):
    """The tiered kernels captured once in a CUDA graph read the mapped
    host CSR at fixed device addresses: replayed with new frontiers they
    equal their plain versions (device_loop on the tiered topology)."""
    _in_own_process("_tiered_replayed_under_capture")


# ------------------------------------- 2-byte tables: F16 files, GAT bf16
def _bits16(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("width", [1, 47, 100, 128])
def test_gather_rows_f16_kernel_equals_plain(dev, width):
    """K1 over a float16 table (an F16 feature file), bit-equal to its
    plain version, aligned and 2 bytes off, counted as gather_rows_f16."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    g = _gen(dev, width)
    n = 3000
    feat = torch.randn((n * width + 1,), generator=g,
                       device=dev).to(torch.float16)
    ids = torch.randint(-5, n + 5, (4099,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::3] = EMPTY
    _build.LAUNCHES.reset()
    for table in (feat[:-1].view(n, width), feat[1:].view(n, width)):
        out = gather_rows(table, ids)
        assert out.dtype == torch.float16
        assert torch.equal(_bits16(out), _bits16(gather_rows_plain(table,
                                                                   ids)))
    assert _build.LAUNCHES.snapshot() == {"gather_rows_f16": 2}


@pytest.mark.parametrize("table", ["47", "100", "128", "128 unaligned"])
@pytest.mark.parametrize("fanout", [5, 10, 15, 7, 33])
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_forward_over_f16_is_the_plain_version(dev, table, fanout,
                                                      weighted):
    """K4's forward over a float16 table, both forms and the dst prefix:
    bit-equal to the plain version on the card and to the float32 kernel
    over the same values widened (the sums run in the same order); a
    float16 table that needs a gradient is refused."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_reduce,
        fanout_reduce_plain,
        masked_mean,
        masked_mean_plain,
        prefix_masked_mean,
    )

    width = int(table.split()[0])
    g = _gen(dev, width + fanout + 2)
    n, d = 5000, 1234
    flat = torch.randn((n * width + 1,), generator=g,
                       device=dev).to(torch.float16)
    h = (flat[1:] if table.endswith("unaligned") else flat[:-1]).view(
        n, width)
    neigh = torch.randint(-2, n + 2, (d, fanout), generator=g, device=dev,
                          dtype=torch.int32)
    neigh[torch.rand((d, fanout), generator=g, device=dev) < 0.3] = EMPTY
    w = (torch.rand((d, fanout), generator=g, device=dev) + 0.5
         if weighted else None)
    wide = h.float()
    _build.LAUNCHES.reset()
    for fn, plain in ((fanout_reduce, fanout_reduce_plain),
                      (masked_mean, masked_mean_plain)):
        out, den = fn(h, neigh, w)
        ref, den_ref = plain(h, neigh, w)
        assert out.dtype == den.dtype == torch.float32
        assert torch.equal(out, ref) and torch.equal(den, den_ref)
        assert torch.equal(out, fn(wide, neigh, w)[0])
    h_dst, mean, _ = prefix_masked_mean(h, neigh, w)
    assert torch.equal(mean, out) and h_dst.data_ptr() == h.data_ptr()
    assert _build.LAUNCHES.snapshot() == {"fanout_fwd_f16": 3,
                                          "fanout_fwd": 2}
    with pytest.raises(NotImplementedError, match="float16"):
        masked_mean(h.clone().requires_grad_(), neigh, w)


_ATTEND16_CASES = [(dt, "shared", h, w, k) for dt in ("bf16", "f16")
                   for h in (1, 8) for w in (47, 100, 128) for k in (5, 15)]
_ATTEND16_CASES += [(dt, "per_head", h, w, 10) for dt in ("bf16", "f16")
                    for h in (1, 2) for w in (47, 128) if w % h == 0]
_ATTEND16_CASES += [("bf16", "shared", 4, 256, 40), ("f16", "shared", 2,
                                                      128, 40)]


@pytest.mark.parametrize("dtype,mode,heads,width,fanout", _ATTEND16_CASES)
def test_attend_over_2_byte_tables_equals_plain(dev, dtype, mode, heads,
                                                width, fanout):
    """K5 over a bfloat16 or float16 table: the forward (out, m, s) and the
    backward's g_el_dst and g_proj (no table gradient) equal the float32
    kernels' over the same values widened, bit for bit (the loads widen
    exactly and the arithmetic is the float32 kernel's), and the plain
    versions within the float32 cases' bounds; a 2-byte table that needs
    a gradient is refused."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.attend import (
        attend_backward,
        attend_backward_plain,
        attend_forward,
        attend_forward_plain,
        gat_attend,
    )

    tdt = torch.bfloat16 if dtype == "bf16" else torch.float16
    wide, neigh, el, proj = _attend_inputs(dev, mode, heads, width,
                                           heads * 100 + width + fanout,
                                           k=fanout, dtype=tdt)
    narrow = wide.to(tdt)
    _build.LAUNCHES.reset()
    got = attend_forward(narrow, neigh, el, proj, mode)
    assert _build.LAUNCHES.snapshot() == {f"attend_fwd_{dtype}": 1}
    for a, b in zip(got, attend_forward(wide, neigh, el, proj, mode)):
        assert torch.equal(a, b)
    for a, b in zip(got, attend_forward_plain(narrow, neigh, el, proj,
                                              mode)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    out, m, s = got
    g_out = torch.randn(out.shape, generator=_gen(dev, 1), device=dev)
    back = attend_backward(g_out, narrow, neigh, el, proj, m, s, mode, False)
    assert back[0] is None
    for a, b in zip(back[1:], attend_backward(g_out, wide, neigh, el, proj,
                                              m, s, mode, False)[1:]):
        assert torch.equal(a, b)
    want = attend_backward_plain(g_out, narrow, neigh, el, proj, m, s, mode,
                                 False)
    torch.testing.assert_close(back[1], want[1], rtol=1e-4, atol=1e-4)
    assert _rel_norm(back[2], want[2]) < 1e-5
    with pytest.raises(NotImplementedError):
        attend_backward(g_out, narrow, neigh, el, proj, m, s, mode, True)
    with pytest.raises(NotImplementedError):
        gat_attend(narrow.clone().requires_grad_(), neigh, el, proj, mode)


@pytest.mark.parametrize("width", [12, 100, 128, 7])
@pytest.mark.parametrize("mean", [False, True])
def test_spmm_f16_kernel_is_the_cpu_plain_version(dev, width, mean):
    """K6a's float16 form against its plain version on the CPU, bit for
    bit on every row (both sum each segment in CSR order, round, and add
    the segments in JAX's order): rows of degree 0 to 40, a row of 2049
    edges (a partial segment of one edge, added first) and a hub of 9000
    (a partial of 808, first), and one of 6000 (1904: last) and 4096 (two
    whole segments); two launches equal; an unaligned view (the 2-byte
    path) too."""
    from xgnn_tpu_torch.ops import _build, spmm

    rng = np.random.default_rng(width)
    n = 3000
    deg = rng.integers(0, 41, n)
    deg[rng.choice(n, 100, replace=False)] = 0
    deg[5], deg[n // 2], deg[7], deg[9] = 2049, 9000, 6000, 4096
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                              .astype(np.int32))
    indices = torch.from_numpy(rng.integers(0, n, int(indptr[-1]))
                               .astype(np.int32))
    flat = (3 * torch.randn((n * (width + 1),),
                            generator=_gen(torch.device("cpu"), width))
            ).to(torch.float16)
    _build.LAUNCHES.reset()
    for h in (flat[: n * width].view(n, width),
              flat[1: n * width + 1].view(n, width)):
        out = spmm.spmm_csr(indptr.to(dev), indices.to(dev), h.to(dev),
                            num_node=n, mean=mean)
        again = spmm.spmm_csr(indptr.to(dev), indices.to(dev), h.to(dev),
                              num_node=n, mean=mean)
        torch.cuda.synchronize()
        assert out.dtype == torch.float16 and torch.equal(out, again)
        ref = spmm.spmm_csr(indptr, indices, h, num_node=n, mean=mean)
        assert torch.equal(_bits16(out.cpu()), _bits16(ref))
    assert _build.LAUNCHES.snapshot() == {"spmm_csr_f16": 4}


@pytest.mark.parametrize("width", [3, 100, 128])
@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("pct", [0.0, 0.3])
def test_tiered_extract_over_an_f16_host_table(dev, width, dtype, pct):
    """K11 over a float16 host table (an F16 feature file): the cache, the
    extract's rows (float16 copied, or under feat_dtype "bfloat16" rounded
    from the float16 as the SMs write them) and the counts equal the plain
    version's, bit for bit; the miss bytes are the host's 2 a value."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import tiered_extract_plain
    from xgnn_tpu_torch.store import TieredFeatureSource

    g = _gen(torch.device("cpu"), width)
    num_node, n = 3000, 5000
    feat = torch.randn((num_node, width), generator=g).to(torch.float16)
    ranking = torch.randperm(num_node, generator=g).to(torch.int32)
    want = torch.bfloat16 if dtype else torch.float16
    src = TieredFeatureSource(feat, ranking, pct, dev,
                              torch.bfloat16 if dtype else None)
    assert src.cache_feat.dtype == want
    assert src.feat_host.dtype == torch.float16
    cached = (src.posmap != EMPTY).nonzero().flatten()
    assert torch.equal(_bits16(src.cache_feat[src.posmap[cached].long()]
                               .cpu()),
                       _bits16(feat[cached.cpu()].to(want)))
    ids = torch.randint(-5, num_node + 5, (n,), generator=g,
                        dtype=torch.int32)
    ids[torch.rand(n, generator=g) < 0.3] = EMPTY
    ids = ids.to(dev)
    num = torch.tensor(4000, dtype=torch.int32, device=dev)
    _build.LAUNCHES.reset()
    out, info = src.extract(ids, num)
    name = "tiered_direct_f16_bf16" if dtype else "tiered_direct_f16"
    assert _build.LAUNCHES.snapshot() == {"tiered_split": 1, name: 1}
    ref, counts = tiered_extract_plain(ids, num, src.posmap, src.cache_feat,
                                       src.feat_host)
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype == want
    assert torch.equal(_bits16(out), _bits16(ref))
    assert [int(info["num_hit"]), int(info["num_miss"])] == counts.tolist()
    assert int(info["miss_bytes"]) == int(counts[1]) * width * 2


@pytest.mark.parametrize("num_parts", [1, 2, 3, 4, 8, 32])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 100_003])
@pytest.mark.parametrize("tight", [False, True])
def test_plan_exchange_kernel_equals_plain(dev, num_parts, n, tight):
    """K13-plan bit-equal to its plain version (send, pick and the
    overflow flag), across tile edges, with EMPTY runs and with a
    segment that overflows; one wrapper launch a call."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.parallel.exchange import (
        plan_exchange,
        plan_exchange_plain,
    )

    g = _gen(dev, n + num_parts)
    ids = torch.randint(0, 3 * n + 7, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::5] = EMPTY
    ids[n // 3:n // 3 + 700] = EMPTY
    seg = max(n // (4 * num_parts), 1) if tight else max(n, 1)
    _build.LAUNCHES.reset()
    got = plan_exchange(ids, num_parts, seg)
    assert _build.LAUNCHES.snapshot() == {"plan_exchange": 1}
    want = plan_exchange_plain(ids.cpu(), num_parts, seg)
    for name in ("send", "pick"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    assert bool(got.overflow) == bool(want.overflow)


def _plan_equal(got, ids, num_parts, seg, hot_limit=None):
    from xgnn_tpu_torch.parallel.exchange import plan_exchange_plain

    want = plan_exchange_plain(ids.cpu(), num_parts, seg,
                               hot_limit=hot_limit)
    for name in ("send", "pick", "overflow"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    return want


@pytest.mark.parametrize("case", ["all EMPTY", "one owner",
                                  "all past hot_limit", "2^24 ids"])
@pytest.mark.parametrize("num_parts", [1, 3, 8, 32])
def test_plan_exchange_edge_cases(dev, case, num_parts):
    """K13-plan bit-equal to its plain version where every request is
    EMPTY, where one owner takes them all (its segment overflows, the
    others are all EMPTY), where every id is at or past ``hot_limit``, and
    on 2^24 ids (8,192 tiles, more than the card holds blocks at once, so
    the look-back waits on tiles whose blocks started earlier)."""
    from xgnn_tpu_torch.parallel.exchange import plan_exchange

    g = _gen(dev, num_parts)
    n, hot_limit = 70_001, None
    if case == "2^24 ids":
        n = 2**24
    ids = torch.randint(0, 50 * n, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if case == "all EMPTY":
        ids.fill_(EMPTY)
    elif case == "one owner":
        ids = ids - ids % num_parts + num_parts - 1
    elif case == "all past hot_limit":
        hot_limit = int(ids.min())
    else:
        ids[::7] = EMPTY
    seg = -(-n // num_parts) + 3
    got = plan_exchange(ids, num_parts, seg, hot_limit)
    want = _plan_equal(got, ids, num_parts, seg, hot_limit)
    assert bool(want.overflow) == (case == "one owner" and num_parts > 1)


def test_plan_exchange_is_one_kernel_and_a_memset(dev):
    """A call is one kernel, named ``plan_*`` (``chip_smoke.py`` groups the
    profiler's records by it), and one memset on the profiler's device
    events (three calls profiled after a fill, whose record the session
    may lose as its first; taken again where it lost one of ours), in a
    buffer of the size the kernel takes; the overflow comes back as a
    bool, and nothing else launches."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.parallel.exchange import plan_exchange, plan_layout

    ids = torch.randint(0, 3_000_000, (1_007_360,), generator=_gen(dev, 4),
                        device=dev, dtype=torch.int32)
    ids[950_000:] = EMPTY
    plan_exchange(ids, 8, 140_000)  # loaded
    torch.cuda.synchronize()
    lead = torch.empty(4, device=dev)

    def run():
        lead.fill_(1.0)  # the session's first record, which it may lose
        return [plan_exchange(ids, 8, 140_000) for _ in range(3)]

    for _ in range(3):  # a session that lost a record is taken again
        events, plans = _device_kernels(run)
        events = [e for e in events if "Fill" not in e]
        kernels = [e for e in events if "plan_" in e]
        memsets = [e for e in events if e.startswith("Memset")]
        if len(kernels) == 3 and len(memsets) == 3:
            break
    assert len(kernels) == 3 and len(memsets) == 3, events
    assert len(events) == 6, events
    got = plans[-1]
    assert got.overflow.dtype == torch.bool and got.overflow.dim() == 0
    _plan_equal(got, ids, 8, 140_000)
    lib = _build.load("exchange")
    for n, p, seg in ((0, 1, 1), (1, 3, 5), (2048, 8, 300), (2049, 32, 1),
                      (1_007_360, 8, 157_400)):
        assert lib.xg_plan_buffer_words(n, p, seg) == plan_layout(n, p,
                                                                  seg)[2]


def _plan_replayed_under_capture(dev):
    from xgnn_tpu_torch.parallel.exchange import plan_exchange

    g = _gen(dev, 31)
    n, p, seg = 300_000, 4, 70_000
    ids = torch.randint(0, 10**6, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        plan_exchange(ids, p, seg, 900_000)  # loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        plan = plan_exchange(ids, p, seg, 900_000)
    for i in range(4):
        new = torch.randint(0, 10**6, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        new[i * 1000:(i + 1) * 50_000] = EMPTY
        if i == 3:  # one owner takes every request: the replay overflows
            new = new - new % p
        ids.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        want = _plan_equal(plan, ids, p, seg, 900_000)
        assert bool(want.overflow) == (i == 3)


def test_plan_exchange_replayed_under_capture(dev):
    """K13-plan captured once in a CUDA graph (its memset and kernel),
    replayed on four sets of ids copied into its input: each replay equals
    the plain version, the last one's overflow among them, so no state of
    the call is baked into the graph."""
    _in_own_process("_plan_replayed_under_capture")


def test_plan_exchange_two_streams_at_once(dev):
    """Two streams with no ordering between them plan at the same time
    (the Prefetcher's side stream beside the training stream): each plan
    equals the plain version."""
    from xgnn_tpu_torch.parallel.exchange import plan_exchange

    g = _gen(dev, 17)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    cases = [[torch.randint(0, 10**7, (n,), generator=g, device=dev,
                            dtype=torch.int32) for n in (1_007_360, 133_376,
                                                         8000)]
             for _ in streams]
    torch.cuda.synchronize()
    plans = [[], []]
    for i in range(3):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                ids = cases[k][i]
                plans[k].append(plan_exchange(ids, 2 + 2 * k,
                                              ids.shape[0] // 3))
    torch.cuda.synchronize()
    for k in range(2):
        for ids, plan in zip(cases[k], plans[k]):
            _plan_equal(plan, ids, 2 + 2 * k, ids.shape[0] // 3)


@pytest.mark.parametrize("w,l,fanout", [(4, 3, 5), (4, 3, 12), (3, 5, 2),
                                        (1, 2, 1), (8, 8, 64)])
def test_walk_topk_kernel_equals_plain(dev, w, l, fanout):
    """K9's count and ranking over given visits, as the partitioned walk
    hands them over, bit-equal to the plain version (ties, EMPTY visits
    and visits equal to the seed among them)."""
    from xgnn_tpu_torch.ops.random_walk import walk_topk, walk_topk_plain

    g = _gen(dev, w * l + fanout)
    b = 3001
    frontier = torch.randint(0, 40, (b,), generator=g, device=dev,
                             dtype=torch.int32)
    frontier[-7:] = EMPTY
    visits = torch.randint(0, 40, (b, w, l), generator=g, device=dev,
                           dtype=torch.int32)
    visits[::4, :, 0] = EMPTY
    visits[1::3, 0] = frontier[1::3, None]
    got = walk_topk(visits, frontier, fanout)
    want = walk_topk_plain(visits.cpu(), frontier.cpu(), fanout)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("use_dist_graph", [True, False])
def test_multichip_engine_p1_on_the_card(dev, use_dist_graph):
    """MultiChipEngine in a world of one over NCCL: epochs that learn, five
    K13 launches a graphsage step (three layers, features, labels) on the
    partitioned topology and two on the replicated one, and the group
    ended by close()."""
    import torch.distributed as dist

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.ops import _build

    ds = make_device_dataset(20_000, 200_000, 32, 8, train_frac=0.2, seed=1,
                             dedup=False)
    cfg = RunConfig(model="graphsage", batch_size=500, fanout=(10, 5),
                    num_layer=2, num_hidden=32, num_worker=1, arch="arch6",
                    use_dist_graph=use_dist_graph, part_cache=True,
                    dropout=0.0)
    eng = MultiChipEngine(ds, cfg).init()
    try:
        assert eng.mesh.backend == "nccl"
        r0 = eng.train_epoch(0)
        _build.LAUNCHES.reset()
        r1 = eng.train_epoch(1)
        torch.cuda.synchronize()
        counts = _build.LAUNCHES.snapshot()
        plans = (len(cfg.fanout) + 2) if use_dist_graph else 2
        assert counts["plan_exchange"] == plans * r1["steps"], counts
        assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
        assert 0.0 <= eng.evaluate("valid") <= 1.0
    finally:
        eng.close()
    assert not dist.is_initialized()


@pytest.mark.parametrize("case", ["no_miss", "one_row", "one_pass",
                                  "one_pass_plus_one", "many_passes",
                                  "empty"])
def test_tiered_split_positions_kernel_equals_plain(dev, case):
    """K11's position form (the two-phase GGMS's lookup) bit-equal to its
    plain version: each slot's cache position or EMPTY, the counts and the
    miss list; no row is written, and it is one launch of its own name."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import (
        tiered_split_positions,
        tiered_split_positions_plain,
    )

    host, posmap, _, ids, num = _miss_case(dev, case)
    _build.LAUNCHES.reset()
    pos, counts, miss_pos, miss_ids = tiered_split_positions(ids, num,
                                                             posmap)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.snapshot() == (
        {} if case == "empty" else {"tiered_split_positions": 1})
    p_pos, p_counts, p_mpos, p_mids = tiered_split_positions_plain(
        ids.cpu(), num.cpu(), posmap.cpu())
    nm = int(p_counts[1])
    assert torch.equal(pos.cpu(), p_pos)
    assert torch.equal(counts.cpu(), p_counts)
    assert torch.equal(miss_pos[:nm].cpu(), p_mpos[:nm])
    assert torch.equal(miss_ids[:nm].cpu(), p_mids[:nm])
    host.close()


def _positions_ids(dev, n, case):
    """``(ids, num_input, posmap)`` of n ids over a 50,000-node posmap
    holding 10,000 rows: "mixed" (hits, misses, EMPTY and out-of-range
    ids), "no_miss" (every id cached) and "all_miss" (none), and "dead"
    (mixed, with num_input short of n)."""
    g = torch.Generator().manual_seed(n + len(case))
    num_node = 50_000
    posmap = torch.full((num_node,), EMPTY, dtype=torch.int32)
    cached = torch.randperm(num_node, generator=g)[:10_000]
    posmap[cached] = torch.randperm(10_000, generator=g).to(torch.int32)
    if case == "no_miss":
        ids = cached[torch.randint(0, 10_000, (n,), generator=g)]
    elif case == "all_miss":
        ids = torch.nonzero(posmap == EMPTY).flatten()[
            torch.randint(0, num_node - 10_000, (n,), generator=g)]
    else:
        ids = torch.randint(-3, num_node + 3, (n,), generator=g)
        ids[::7] = EMPTY
    num = n - n // 3 if case == "dead" else n
    return (ids.to(torch.int32).to(dev),
            torch.tensor(num, dtype=torch.int32, device=dev), posmap.to(dev))


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 40 * 2048 + 5,
                               1_007_360])
@pytest.mark.parametrize("case", ["mixed", "no_miss", "all_miss", "dead"])
def test_split_positions_one_pass_equals_plain(dev, n, case):
    """K11's position form in one pass (a ticket and a decoupled look-back
    over the tiles of 2,048 ids) bit-equal to its plain version at 1 id,
    a tile less one, a tile, a tile and one, 40 tiles and the main path's
    layer-2 size; many tiles with no misses and with all misses; and
    num_input < n."""
    from xgnn_tpu_torch.ops.tiered import (
        tiered_split_positions,
        tiered_split_positions_plain,
    )

    ids, num, posmap = _positions_ids(dev, n, case)
    pos, counts, miss_pos, miss_ids = tiered_split_positions(ids, num,
                                                             posmap)
    p_pos, p_counts, p_mpos, p_mids = tiered_split_positions_plain(
        ids.cpu(), num.cpu(), posmap.cpu())
    nm = int(p_counts[1])
    assert torch.equal(pos.cpu(), p_pos)
    assert torch.equal(counts.cpu(), p_counts)
    assert torch.equal(miss_pos[:nm].cpu(), p_mpos[:nm])
    assert torch.equal(miss_ids[:nm].cpu(), p_mids[:nm])
    if case == "no_miss":
        assert nm == 0 and int(p_counts[0]) == n
    if case == "all_miss":
        assert nm == n


def test_split_positions_is_one_kernel_and_a_memset(dev):
    """A call of the position form is one memset and one kernel on the
    profiler's device events (three calls profiled after a fill, whose
    record the session may lose as its first)."""
    from xgnn_tpu_torch.ops.tiered import tiered_split_positions

    ids, num, posmap = _positions_ids(dev, 1_007_360, "mixed")
    tiered_split_positions(ids, num, posmap)  # loaded
    torch.cuda.synchronize()
    lead = torch.empty(4, device=dev)

    def run():
        lead.fill_(1.0)
        return [tiered_split_positions(ids, num, posmap) for _ in range(3)]

    for _ in range(3):
        events, _ = _device_kernels(run)
        events = [e for e in events if "Fill" not in e]
        kernels = [e for e in events if "split_positions" in e]
        memsets = [e for e in events if e.startswith("Memset")]
        if len(kernels) == 3 and len(memsets) == 3:
            break
    assert len(kernels) == 3 and len(memsets) == 3, events
    assert len(events) == 6, events


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("partitioned", [True, False])
def test_two_phase_rows_equal_plain(dev, dtype, partitioned):
    """The two-phase step's input rows at P = 1 over NCCL (K11's position
    form, the owner exchange's K13 and K1, K11's reads in place; or K11's
    split over the whole cache) bit-equal to the same ids' rows read by the
    plain versions: float32, a bfloat16 cache over a float32 host, and a
    float16 host and cache."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import MappedHostTable, tiered_direct
    from xgnn_tpu_torch.ops.tiered import tiered_extract_plain
    from xgnn_tpu_torch.parallel import ggms
    from xgnn_tpu_torch.parallel.mesh import make_mesh

    g = _gen(torch.device("cpu"), 23)
    num_node, width, n = 20_000, 100, 30_000
    feat = torch.randn((num_node, width), generator=g)
    if dtype == "float16":
        feat = feat.to(torch.float16)
    cache_dtype = torch.bfloat16 if dtype == "bfloat16" else None
    ranking = torch.randperm(num_node, generator=g).to(torch.int32).numpy()
    ids = torch.randint(0, num_node, (n,), generator=g, dtype=torch.int32)
    ids[torch.rand(n, generator=g) < 0.2] = EMPTY
    ids = ids.to(dev)
    num = torch.tensor(n - 1000, dtype=torch.int32, device=dev)
    host = MappedHostTable(feat, dev)
    mesh = make_mesh(dev)
    try:
        posmap, cache, _ = ggms.build_cache(host, ranking, 0.2, 1, 0, dev,
                                            cache_dtype)
        _build.LAUNCHES.reset()
        rows, miss_ids, miss_pos, counts, of = ggms.cache_split(
            posmap, cache, ids, num, mesh, n, host, partitioned)
        x = tiered_direct(rows, miss_ids, miss_pos, counts, host)
        torch.cuda.synchronize()
        launches = _build.LAUNCHES.snapshot()
        ref, ref_counts = tiered_extract_plain(ids.cpu(), num.cpu(),
                                               posmap.cpu(), cache.cpu(),
                                               host.tensor)
        assert not bool(of)
        assert x.dtype == ref.dtype
        assert torch.equal(x.cpu().view(torch.int16) if x.element_size() == 2
                           else x.cpu(),
                           ref.view(torch.int16) if ref.element_size() == 2
                           else ref)
        assert torch.equal(counts.cpu(), ref_counts)
        split = ({"tiered_split_positions": 1, "plan_exchange": 1}
                 if partitioned else {"tiered_split": 1})
        assert all(launches.get(k) == v for k, v in split.items()), launches
        assert sum(v for k, v in launches.items()
                   if k.startswith("tiered_direct")) == 1, launches
    finally:
        mesh.close()
        host.close()


@pytest.mark.parametrize("part_cache", [True, False])
def test_multichip_engine_two_phase_on_the_card(dev, part_cache):
    """MultiChipEngine with a partial cache in a world of one over NCCL:
    epochs that learn, K11's position form (or its split over the whole
    cache) and its reads once a step, a hit rate in (0, 1), and the
    dynamic refresh moving the posmap."""
    import torch.distributed as dist

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.ops import _build

    ds = make_device_dataset(20_000, 200_000, 32, 8, train_frac=0.2, seed=1,
                             dedup=False)
    cfg = RunConfig(model="graphsage", batch_size=500, fanout=(10, 5),
                    num_layer=2, num_hidden=32, num_worker=1, arch="arch6",
                    use_dist_graph=True, part_cache=part_cache,
                    cache_percentage=0.2, cache_policy="dynamic_cache",
                    num_epoch=3, dropout=0.0)
    eng = MultiChipEngine(ds, cfg).init()
    try:
        posmap0 = eng.posmap.clone()
        r0 = eng.train_epoch(0)
        assert not torch.equal(eng.posmap, posmap0)
        _build.LAUNCHES.reset()
        r1 = eng.train_epoch(1)
        torch.cuda.synchronize()
        counts = _build.LAUNCHES.snapshot()
        split = "tiered_split_positions" if part_cache else "tiered_split"
        # the step's, then the refresh's all-miss cache build
        assert counts[split] == r1["steps"] + (0 if part_cache else 1)
        assert counts["tiered_direct"] == r1["steps"] + 1, counts
        assert np.isfinite(r0["loss"]) and r1["loss"] < r0["loss"]
        assert 0.0 < r0["hit_rate"] < 1.0 and 0.0 < r1["hit_rate"] < 1.0
        assert 0.0 <= eng.evaluate("valid") <= 1.0
    finally:
        eng.close()
    assert not dist.is_initialized()


# ------------------------------------ the partitioned topology's cold tier
@pytest.fixture(scope="module")
def cold_graph():
    """A weighted graph and its host CSR, mapped for the card and plain on
    the CPU, with the hot prefix at 40% of its nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from xgnn_tpu_torch import synthetic
    from xgnn_tpu_torch.store.topology import MappedHostCSR, Tier

    ds = synthetic.make_synthetic_dataset(num_node=5000, avg_degree=20,
                                          feat_dim=8, num_class=4, seed=1)
    synthetic.build_alias_tables(ds, seed=1)
    tables = dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                  prob_prefix_table=ds.prob_prefix_table)
    ip = ds.indptr.astype(np.int64)
    dev = torch.device("cuda", 0)
    card = MappedHostCSR(ip, ds.indices, device=dev, **tables)
    host = MappedHostCSR(ip, ds.indices, **tables)
    yield ds, Tier(2000, card), Tier(2000, host)
    card.close()


@pytest.mark.parametrize("form", ["khop", "uniform_wr", "khop1", "alias",
                                  "alias_dedup", "prefix"])
@pytest.mark.parametrize("kind", ["mixed", "all_cold", "no_cold"])
@pytest.mark.parametrize("fanout", [5, 7])
def test_cold_form_kernel_equals_plain(dev, cold_graph, form, kind, fanout):
    """The samplers' cold form (no device CSR: the partitioned topology's
    requesting rank) bit-equal to its plain version on frontiers of mixed
    ids, of cold ids only and of hot ids only (all EMPTY rows); one launch
    a call."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import sampling as ps

    ds, tier, tier_cpu = cold_graph
    g = torch.Generator().manual_seed(fanout)
    n, ncn = 3001, tier.num_cache_node
    lo, hi = {"mixed": (0, ds.num_node), "all_cold": (ncn, ds.num_node),
              "no_cold": (0, ncn)}[kind]
    f = torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)
    f[::7] = EMPTY
    width = ps.HASH_DEDUP_ROUNDS * fanout if form == "alias_dedup" else fanout
    u = torch.rand((n, width), generator=g)
    coin = (torch.rand((n, width), generator=g)
            if form in ("alias", "alias_dedup") else None)
    _build.LAUNCHES.reset()
    got = ps.sample_cold(form, tier, f.to(dev), fanout, u=u.to(dev),
                         coin=None if coin is None else coin.to(dev))
    assert _build.LAUNCHES.snapshot() == {
        ps.COLD_FORMS[form][1] + "_cold": 1}
    want = ps.sample_cold(form, tier_cpu, f, fanout, u=u, coin=coin)
    assert torch.equal(got.cpu(), want)
    cold = (f != EMPTY) & (f >= ncn)
    assert bool((want[~cold] == EMPTY).all())
    assert (kind == "no_cold") == (not bool((want != EMPTY).any()))


@pytest.mark.parametrize("num_parts", [1, 2, 4, 32])
@pytest.mark.parametrize("hot_limit", [0, 1000, 2999, None])
def test_plan_exchange_hot_limit_kernel_equals_plain(dev, num_parts,
                                                     hot_limit):
    """K13-plan with the hot mask folded in: ids at or past ``hot_limit``
    are not sent and pick EMPTY, bit-equal to the plain version."""
    from xgnn_tpu_torch.parallel.exchange import (
        plan_exchange,
        plan_exchange_plain,
    )

    g = _gen(dev, num_parts + (hot_limit or 7))
    ids = torch.randint(0, 3000, (9001,), generator=g, device=dev,
                        dtype=torch.int32)
    ids[::5] = EMPTY
    seg = 9001 // num_parts // 3 + 1
    got = plan_exchange(ids, num_parts, seg, hot_limit)
    want = plan_exchange_plain(ids.cpu(), num_parts, seg,
                               hot_limit=hot_limit)
    for name in ("send", "pick", "overflow"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


def _closure_parts_layers(dev, indptr, indices, num_node, p, seeds, layers):
    """Every part of ``p`` in turn, ``layers`` layers then the count, the
    kernel on the card and the plain version on the CPU side by side from
    the same state: each call's out (or counts), levels and known set
    bit-equal; the reduce by owner summed here.  ``seeds``: a list of ids a
    lane (EMPTY and out-of-range ids dropped, as the step drops them).
    Returns the parts' counts and the marks sent."""
    from xgnn_tpu_torch.ops.presample import (
        closure_known,
        closure_parts,
        closure_parts_plain,
    )
    from xgnn_tpu_torch.parallel.dist_topology import partition_part

    ip, ix = indptr.cpu().long(), indices.cpu()
    parts = [partition_part(ip, ix, p, r) for r in range(p)]
    rows = parts[0].indptr.shape[0] - 1
    card = [(t.indptr.to(dev), t.indices.to(dev)) for t in parts]
    recv = [torch.zeros((p, rows), dtype=torch.uint8) for _ in range(p)]
    for lane, vs in enumerate(seeds):
        for v in vs:
            if 0 <= v < num_node:
                recv[v % p][lane, v // p] = 1
    level = [torch.zeros((p, rows), dtype=torch.uint8) for _ in range(p)]
    known = [closure_known(rows, p, "cpu") for _ in range(p)]
    level_d = [t.to(dev, copy=True) for t in level]
    known_d = [t.to(dev, copy=True) for t in known]
    sent = []
    for tag in range(1, layers + 1):
        outs = []
        for r in range(p):
            out = closure_parts(*card[r], level_d[r], recv[r].to(dev), tag,
                                num_node, r, known_d[r])
            ref = closure_parts_plain(parts[r].indptr, parts[r].indices,
                                      level[r], recv[r], tag, num_node, r,
                                      known[r])
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), ref), (tag, r)
            assert torch.equal(level_d[r].cpu(), level[r]), (tag, r)
            assert torch.equal(known_d[r].cpu(), known[r]), (tag, r)
            outs.append(ref)
        sent.append(sum(int(o.sum()) for o in outs))
        recv = [(sum(o[w].int() for o in outs) > 0).to(torch.uint8)
                for w in range(p)]
    counts = []
    for r in range(p):
        c = torch.arange(rows, dtype=torch.int32) % 3
        c_d = c.to(dev, copy=True)
        closure_parts(*card[r], level_d[r], recv[r].to(dev), layers + 1,
                      num_node, r, known_d[r], counts=c_d)
        closure_parts_plain(parts[r].indptr, parts[r].indices, level[r],
                            recv[r], layers + 1, num_node, r, known[r],
                            counts=c)
        torch.cuda.synchronize()
        assert torch.equal(c_d.cpu(), c) and torch.equal(
            level_d[r].cpu(), level[r])
        counts.append(c - torch.arange(rows, dtype=torch.int32) % 3)
    return counts, sent


@pytest.mark.parametrize("num_parts", [1, 3, 8, 32])
def test_closure_parts_kernel_equals_plain(dev, cold_graph, num_parts):
    """K12b's partitioned form, layer by layer over each part of P (the
    update, the owner-major marks of the reached rows' destinations that
    the part does not know of, the levels, the known set carried over 4
    layers) and its count, bit-equal to the plain version (JAX's
    edge-parallel form with the same known set); the counts over the parts
    are the single store's closure of each lane's seeds; the sizes the
    wrapper allocates are the kernel's."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.presample import closure_expand_plain

    ds = cold_graph[0]
    p = num_parts
    g = np.random.default_rng(p)
    seeds = [list(g.integers(0, ds.num_node, 25)) for _ in range(p)]
    indptr = torch.from_numpy(ds.indptr.astype(np.int32))
    indices = torch.from_numpy(ds.indices)
    counts, sent = _closure_parts_layers(dev, indptr, indices, ds.num_node,
                                         p, seeds, 4)
    want = torch.zeros(ds.num_node, dtype=torch.int32)
    for lane in seeds:
        closure_expand_plain(indptr, indices,
                             torch.tensor(lane, dtype=torch.int32), 4, want)
    got = torch.zeros(counts[0].shape[0] * p, dtype=torch.int32)
    for r in range(p):
        got[r::p] = counts[r]
    assert torch.equal(got[:ds.num_node], want)
    assert sent[0] > 0
    lib = _build.load("presample")
    for rows in (1, 31, 32, 33, 1000):
        assert lib.xg_closure_parts_known_words(rows, p) == -(
            -rows * p * (1 << (p - 1).bit_length()) // 32)


@pytest.mark.parametrize("case", ["star", "chain", "fills at layer 1",
                                  "odd targets", "claims beside the frontier"])
@pytest.mark.parametrize("num_parts", [1, 3])
def test_closure_parts_edge_cases(dev, case, num_parts):
    """K12b's edge-case graphs (a hub of 12,345 edges in chunks, a chain, a
    closure that fills at layer 1, EMPTY and out-of-range destinations,
    tiles whose rows are reached beside the frontier) through the
    partitioned form, every part, 4 layers and the count, bit-equal to the
    plain version; the lanes past the first start from other seeds."""
    indptr, indices, seeds = _closure_graph(dev, case)
    n = indptr.shape[0] - 1
    lanes = [seeds] + [[(v * 7 + lane) % n for v in seeds if 0 <= v < n]
                       for lane in range(1, num_parts)]
    counts, _ = _closure_parts_layers(dev, indptr, indices, n, num_parts,
                                      lanes, 4)
    assert sum(int(c.sum()) for c in counts) > 0


def test_closure_parts_ranking_at_p1_is_the_single_store(dev):
    """At P = 1 the partitioned form over a power-law graph (200,003 nodes,
    2.5M edges), batch after batch as the exact step runs it (the reduce
    at P = 1 is the out itself), counts what ``closure_expand_plain``
    counts over the same batches; one launch counted a call."""
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.presample import (
        closure_expand_plain,
        closure_known,
        closure_parts,
    )

    ds = make_device_dataset(200_003, 2_500_000, 4, 3, seed=5, device=dev,
                             dedup=False)
    indptr, indices = ds.graph.indptr, ds.graph.indices
    n = ds.num_node
    got = torch.zeros(n, dtype=torch.int32, device=dev)
    want = torch.zeros(n, dtype=torch.int32, device=dev)
    _build.LAUNCHES.reset()
    for b in range(4):
        seeds = torch.from_numpy(ds.train_set[b * 500:(b + 1) * 500]).to(dev)
        recv = torch.zeros((1, n), dtype=torch.uint8, device=dev)
        recv[0, seeds.long()] = 1
        level = torch.zeros((1, n), dtype=torch.uint8, device=dev)
        known = closure_known(n, 1, dev)
        for tag in (1, 2, 3):
            recv = closure_parts(indptr, indices, level, recv, tag, n, 0,
                                 known)[0].contiguous()
        closure_parts(indptr, indices, level, recv, 4, n, 0, known,
                      counts=got)
        closure_expand_plain(indptr, indices, seeds, 3, want)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) > 100_000
    assert _build.LAUNCHES.snapshot() == {"closure_parts": 16}


@pytest.mark.parametrize("sample_type", ["khop3", "khop1", "weighted_khop",
                                         "weighted_khop_prefix"])
def test_tiered_partitioned_layer_on_card_equals_cpu(dev, cold_graph,
                                                     sample_type):
    """At P = 1 over NCCL the tiered partitioned layer (hot ids through
    the exchange, cold ids through the cold form, merged in one select)
    equals the same layer over gloo on the CPU with the same request-order
    uniforms."""
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.parallel import dist_topology
    from xgnn_tpu_torch.parallel import mesh as pmesh

    ds, tier, tier_cpu = cold_graph
    tables = [torch.from_numpy(t) for t in (
        ds.prob_table, ds.alias_table, ds.prob_prefix_table)]
    ip = torch.from_numpy(ds.indptr.astype(np.int64))
    ix = torch.from_numpy(ds.indices)
    g = torch.Generator().manual_seed(3)
    f = torch.randint(0, ds.num_node, (4000,), generator=g,
                      dtype=torch.int32)
    f[::9] = EMPTY
    u = torch.rand((4000, 5), generator=g)
    coin = torch.rand((4000, 5), generator=g)
    outs = []
    for device, t in ((dev, tier), ("cpu", tier_cpu)):
        topo = dist_topology.partition_part(
            ip.to(device), ix.to(device), 1, 0, tier.num_cache_node,
            *[x.to(device) for x in tables])
        topo.tier = t
        m = pmesh.make_mesh(device)
        try:
            neigh, of = dist_topology.sample_layer_partitioned(
                topo, f.to(device), 5, m, 4000, SampleType(sample_type),
                u=u.to(device), coin=coin.to(device)
                if sample_type == "weighted_khop" else None)
            outs.append((neigh.cpu(), bool(of)))
        finally:
            m.close()
    assert torch.equal(outs[0][0], outs[1][0]) and not outs[0][1]


# ------------------------------------------------ the host's shared tier
@pytest.fixture
def world(dev):
    """A world of one over NCCL on card 0: a host of one rank."""
    from xgnn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dev)
    yield mesh
    mesh.close()


def _shared_k11_case(dev, num_node=60_000, width=128, seed=31):
    """A feature table, a posmap and cache over a fifth of its rows, and
    ids as drawn (EMPTY and out-of-range among them)."""
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((num_node, width), generator=g)
    num_cache = num_node // 5
    posmap = torch.full((num_node,), EMPTY, dtype=torch.int32)
    cached = torch.randperm(num_node, generator=g)[:num_cache]
    posmap[cached] = torch.arange(num_cache, dtype=torch.int32)
    cache = feat[cached].contiguous()
    ids = torch.randint(0, num_node, (40_000,), generator=g,
                        dtype=torch.int32)
    ids[::11] = EMPTY
    ids[5::13] = num_node
    return feat, posmap.to(dev), cache.to(dev), ids.to(dev)


def test_shared_table_is_a_read_only_shm_mapping_that_k11_reads(dev, world):
    """The host's one table (MappedHostTable with a mesh): a read-only
    MAP_SHARED mapping of a file under /dev/shm whose name is gone,
    registered once with cudaHostRegisterPortable | Mapped | ReadOnly; K11's
    whole call over it bit-equal to its plain version; the registration
    gone at close."""
    from xgnn_tpu_torch.ops.tiered import (
        MappedHostTable,
        registrations,
        tiered_extract,
        tiered_extract_plain,
    )
    from xgnn_tpu_torch.store import host_shared

    ok = torch.cuda.get_device_properties(dev)  # the card answers first
    assert ok.total_memory > 0
    feat, posmap, cache, ids = _shared_k11_case(dev)
    host = MappedHostTable(feat, mesh=world)
    assert host.read_only and host.dev_ptr is not None
    assert torch.equal(host.tensor, feat)
    assert registrations(host.tensor) == 1
    mem = host_shared.mapping_memory(host.tensor.data_ptr())
    assert host_shared.PREFIX in mem["path"]
    assert not os.path.exists(host.shared.path)
    out, counts = tiered_extract(ids, 39_000, posmap, cache, host)
    ref, ref_counts = tiered_extract_plain(ids.cpu(), 39_000,
                                           posmap.cpu(), cache.cpu(), feat)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref) and torch.equal(counts.cpu(),
                                                       ref_counts)
    assert int(counts[1]) > 0
    host.close()
    assert registrations(host.tensor) == 0 and host.dev_ptr is None


def test_two_registrations_of_one_mapping_count(dev, world):
    """A second registration of the shared table's memory is counted, not
    made again: the table reads on after one release, and the last
    release unregisters it; a differing range or access at its address is
    refused, and CUDA refuses a range that starts inside it, an error
    cleared before the next launch."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import tiered

    feat, posmap, cache, ids = _shared_k11_case(dev, 20_000, 64, 5)
    host = tiered.MappedHostTable(feat, mesh=world)
    ptr = tiered._map(host.tensor, dev.index, "second", True)
    assert ptr == host.dev_ptr and tiered.registrations(host.tensor) == 2
    with pytest.raises(RuntimeError, match="pinning"):
        tiered._map(host.tensor[:100], dev.index, "range", True)
    with pytest.raises(RuntimeError, match="pinning"):
        tiered._map(host.tensor, dev.index, "access", False)
    with pytest.raises(RuntimeError, match="pinning"):
        tiered._map(host.tensor[100:], dev.index, "overlap", True)
    assert _build.load("tiered").xg_host_unmap(host.tensor.data_ptr(),
                                               dev.index) == 0
    assert tiered.registrations(host.tensor) == 1
    out, _ = tiered.tiered_extract(ids, ids.numel(), posmap, cache, host)
    ref, _ = tiered.tiered_extract_plain(ids.cpu(), ids.numel(),
                                         posmap.cpu(), cache.cpu(), feat)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
    host.close()
    assert tiered.registrations(host.tensor) == 0


def test_a_failed_shared_table_releases_its_registration(dev, world,
                                                         monkeypatch):
    """The second barrier fails after this rank registered its mapping (as
    when another rank fails): the table raises, its registration is gone and
    the file is no longer mapped; a new table of the same size then reads
    right."""
    import gc

    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import tiered
    from xgnn_tpu_torch.store import host_shared

    feat, posmap, cache, ids = _shared_k11_case(dev, 20_000, 64, 7)
    real_agree, real_map = host_shared._agree, tiered._map
    barriers, pinned = [], []

    def agree(world, error, what):
        barriers.append(what)
        if len(barriers) == 2 and error is None:
            error = RuntimeError("another rank's failure")
        real_agree(world, error, what)

    def record(tensor, *args):
        pinned.append(tensor.data_ptr())
        return real_map(tensor, *args)

    monkeypatch.setattr(host_shared, "_agree", agree)
    monkeypatch.setattr(tiered, "_map", record)
    with pytest.raises(RuntimeError, match="another rank's failure"):
        tiered.MappedHostTable(feat, mesh=world)
    monkeypatch.undo()
    gc.collect()
    assert len(pinned) == 1
    assert _build.load("tiered").xg_host_map_count(pinned[0]) == 0
    with open("/proc/self/maps") as f:
        assert f"{host_shared.PREFIX}{world._token}_h0_" not in f.read()
    host = tiered.MappedHostTable(feat, mesh=world)
    out, _ = tiered.tiered_extract(ids, ids.numel(), posmap, cache, host)
    ref, _ = tiered.tiered_extract_plain(ids.cpu(), ids.numel(),
                                         posmap.cpu(), cache.cpu(), feat)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
    host.close()


def test_cold_forms_over_the_shared_csr_equal_plain(dev, world):
    """K2 and K9 (and K8a, K8b) over a tiered topology whose host CSR is
    the host's shared copy (read-only mappings, registered read-only):
    bit-equal to their plain versions and to the untiered kernels."""
    from xgnn_tpu_torch.store.topology import MappedHostCSR, Tier

    g, hot, tier, n = _tiered_graph(dev)
    own = tier.csr
    shared = MappedHostCSR(
        own.host("indptr"), own.host("indices"),
        prob_table=own.host("prob_table"),
        alias_table=own.host("alias_table"),
        prob_prefix_table=own.host("prob_prefix_table"), mesh=world)
    own.close()
    assert all(a.read_only and a.shared is not None
               for a in shared.arrays.values())
    tier = Tier(tier.num_cache_node, shared)
    for k in (5, 10):
        frontier = torch.from_numpy(_tiered_frontier(g, tier, n, k)).to(dev)
        _assert_tiered_equal(dev, g, hot, tier, frontier, k)
    shared.close()


def _shared_tier_device_loop(dev):
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    ds = make_device_dataset(20_000, 200_000, 32, 8, train_frac=0.2, seed=3,
                             dedup=False)
    hist = []
    for device_loop in (False, True):
        cfg = RunConfig(model="graphsage", batch_size=500, fanout=(10, 5),
                        num_layer=2, num_hidden=32, num_worker=1,
                        arch="arch6", use_dist_graph=True, part_cache=True,
                        dist_graph_percentage=0.6, dropout=0.5,
                        device_loop=device_loop)
        eng = MultiChipEngine(ds, cfg).init()
        try:
            assert all(a.shared is not None and a.read_only
                       for a in eng.tier.csr.arrays.values())
            for e in range(2):
                eng.train_epoch(e)
            if device_loop:
                assert eng._fused is not None and eng._fused.graph
            hist.append([eng.history[e]["loss"] for e in range(2)])
        finally:
            eng.close()
    for host, fused in zip(*hist):
        assert np.all(np.isfinite(host))
        np.testing.assert_array_equal(fused, host)


def test_shared_cold_tier_captured_step_replays_like_the_host_loop(dev):
    """The multi-card device_loop over the host's shared cold tier (the
    cold form reading the read-only mapping at addresses fixed at capture):
    two epochs of replays bit-equal to the host loop's losses."""
    _in_own_process("_shared_tier_device_loop")


def _shared_table_two_phase(dev):
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.ops.tiered import registrations

    ds = make_device_dataset(20_000, 200_000, 32, 8, train_frac=0.2, seed=1,
                             dedup=False)
    cfg = RunConfig(model="graphsage", batch_size=500, fanout=(10, 5),
                    num_layer=2, num_hidden=32, num_worker=1, arch="arch6",
                    use_dist_graph=True, part_cache=True,
                    dist_graph_percentage=0.6, cache_percentage=0.2,
                    cache_policy="pre_sample", dropout=0.0)
    eng = MultiChipEngine(ds, cfg).init()
    try:
        assert eng.host.read_only and eng.host.shared is not None
        assert registrations(eng.host.tensor) == 1
        rs = [eng.train_epoch(e) for e in range(2)]
        assert rs[1]["loss"] < rs[0]["loss"]
        assert 0.0 < rs[1]["hit_rate"] < 1.0
    finally:
        eng.close()


def test_two_phase_ggms_on_the_shared_table(dev):
    """The two-phase GGMS with the cold tier over the host's shared table
    and CSR in a world of one: two epochs that learn, a hit rate in (0, 1),
    one registration of the table."""
    _in_own_process("_shared_table_two_phase")
