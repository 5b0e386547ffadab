"""The port's CUDA kernels and its pipelined engine on the card.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one.  The machine with the card has no JAX, so run this file
without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

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


@pytest.mark.parametrize("model", ["graphsage", "pinsage"])
def test_mean_aggregate_launches_no_division(dev, model):
    """SAGEConv and PinSAGEConv divide inside K4: one forward launch a
    layer, and no PyTorch division kernel in the step's forward and
    backward (the profiler's device events); a mean under ``no_grad`` is
    one kernel on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import masked_mean
    from xgnn_tpu_torch.sampler import Sampler

    ds = make_device_dataset(5000, 30_000, 32, 6, seed=2, device=dev)
    cfg = RunConfig(batch_size=128, fanout=(6, 4, 3), num_hidden=32,
                    model=model, dropout=0.0,
                    frontier_capacities=None if model == "pinsage"
                    else (128, 896, 3584, 5000))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(ds.train_set[:128]).to(dev), 128, generator(dev, 1))
    net = build_model(cfg, 32, 6).to(dev)
    torch.cuda.synchronize()
    _build.LAUNCHES.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        net(batch.blocks, ds.feat).square().sum().backward()
        _settle()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    layers = len(batch.blocks)
    assert _build.LAUNCHES.snapshot()["fanout_fwd"] == layers
    assert sum("fanout_fwd_kernel" in x for x in names) == layers
    assert not [x for x in names if "div" in x.lower()]
    neigh = batch.blocks[0].neigh
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as one:
        masked_mean(ds.feat, neigh)
        _settle()
    kernels = [e.name for e in one.events()
               if e.device_type == DeviceType.CUDA]
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
    generation is drawn and launched under one lock, so the card sees
    them in order."""
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
    """The stamp wraps after 2^32 - 1 calls; the wrapper clears the state
    once and starts again at 1."""
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
    trace waits for CUPTI before it stops (``_settle``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xgnn_tpu_torch.ops import unique

    rng = np.random.default_rng(9)
    num_node, cap = 2_449_029, 1_007_360
    case = _dedup_inputs(rng, num_node, 133_376, 123_000, 1_333_760)
    args = _on_card(dev, case)
    _assert_plain(*_dedup(dev, case, cap, num_node), cap)  # state made
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = unique.unique_seeded_split(*args, cap, num_node=num_node)
        _settle()
    grown = torch.cuda.memory_allocated(dev) - before
    _assert_plain(out, args, cap)
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
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

    ds = make_device_dataset(20_000, 100_000, 8, 5, seed=3, device=dev)
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

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev)
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
    out = pick_multiplicity(ids, num_rows)
    assert out.dtype == torch.int32
    assert torch.equal(out, pick_multiplicity_plain(ids, num_rows))
    flat = ids.reshape(-1)[1:]
    assert torch.equal(pick_multiplicity(flat, num_rows),
                       pick_multiplicity_plain(flat, num_rows))
    assert _build.LAUNCHES.snapshot() == {"pick_multiplicity": 2}
    empty = torch.full(shape, EMPTY, dtype=torch.int32, device=dev)
    assert int(pick_multiplicity(empty, num_rows).abs().sum()) == 0


# ------------------------------------------------- K5 edge-softmax attend
def _attend_inputs(dev, mode, heads, width, seed, n=3000, d=1500, k=10):
    """Picks with repeats, EMPTY and out-of-range ids, three all-EMPTY dst
    rows, a src row picked 500 times (past one warp's 32) so that whole dst
    rows repeat one id, and a dst row with one valid pick."""
    g = _gen(dev, seed)
    table = torch.randn((n, width), generator=g, device=dev)
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

    ds = make_device_dataset(5000, 30_000, 32, 6, seed=2, device=dev)
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

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev)
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


@pytest.mark.parametrize("fanout", [1, 5, 15, 64])
@pytest.mark.parametrize("coarse", [True, False])
def test_prefix_kernel_equals_plain(dev, fanout, coarse):
    """K8b-prefix over rows of degree 0, short rows, hubs of 10,000 and
    70,000 entries (searched through their coarse rows), EMPTY and ids
    past N, with and without the coarse CDF."""
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
                             weighted=True)
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
    error is not reported again by the next extract's launch check."""
    from xgnn_tpu_torch.ops import tiered

    host = tiered.MappedHostTable(torch.ones((1000, 8)), dev)
    with pytest.raises(RuntimeError, match="pinning"):
        tiered._map(host.tensor, dev.index)
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
                             device=dev)
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

    ds = make_device_dataset(20_000, 100_000, 32, 7, seed=5, device=dev)
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


@pytest.mark.parametrize("heads,d", [(1, 47), (1, 256), (8, 32), (2, 4)])
@pytest.mark.parametrize("hub_cap", [None, 0])
def test_gat_kernel_equals_plain(dev, heads, d, hub_cap, monkeypatch):
    """K6b against its plain version (JAX's two passes) on the card and on
    the CPU, within 1e-5 of the softmax-weighted aggregate of |feat|; the
    same bits on a second launch; zero rows where a row is empty."""
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
