"""K5's table gradient as the kernels sum it, and GAT's dst-prefix fold,
against the JAX package on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and the port: ``gat_attend`` at one head in both modes and
``gat_attend_prefix`` (``el_dst = h_src[:D] @ wl`` formed inside) against
``jax.vjp`` of ``GATConv._online_attend``, and ``GATConv`` on a local-id
block against ``jax.grad`` of flax ``GATConv``.  The plain one-head
backward (K4's weighted sum over ``g_out`` with weights ``a`` plus the
rank-1 term ``(sum g_pre) * proj``) is held to the per-pick form it
replaced (a gradient row a pick, added by ``index_add_``) within 1e-5 of
the aggregate of the terms' magnitudes, and ``fanout_backward_plain``'s
rank-1 term to its stated order bit for bit.  On the CPU the wrappers take
their plain versions; ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py`` hold the kernels to them on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# the tolerances of test_torch_port_attend.py: float32 sums in other orders
# than XLA's, and g_e's difference keeping its terms' rounding
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _neigh(rng, d, k, n, outside=True):
    """Picks with repeats, EMPTY and (with ``outside``) ids below 0 and
    past the table; dst row 5 all EMPTY, row 6 a single valid pick, row 7
    one id repeated; src rows 2 and 4 (in the prefix) reached by no
    pick."""
    neigh = rng.integers(0, min(n, 16), (d, k)).astype(np.int32)
    bad = rng.random((d, k))
    neigh[bad < 0.2] = EMPTY_KEY
    if outside:
        neigh[(bad >= 0.2) & (bad < 0.25)] = -4
        neigh[(bad >= 0.25) & (bad < 0.3)] = n + 3
    neigh[5] = EMPTY_KEY
    neigh[6] = EMPTY_KEY
    neigh[6, k // 2] = 3
    neigh[7] = 9
    neigh[(neigh == 2) | (neigh == 4)] = EMPTY_KEY
    return neigh


def _jax_attend(table, neigh, el, proj, heads, mode):
    """``GATConv._online_attend`` with the aggregate-first (shared) or the
    transform-first (per-head) score and payload, normalised as
    ``GATConv`` normalises it."""
    from xgnn_tpu.models.gnn import GATConv as JGATConv

    n, width = table.shape
    mask = (neigh >= 0) & (neigh < n)
    idx = jnp.where(mask, neigh, 0)
    conv = JGATConv(out_dim=1, num_heads=heads)
    if mode == "shared":
        shape = (neigh.shape[0], heads, width)

        def score(rows):
            return rows @ proj

        def payload(rows, w):
            return rows[:, None, :] * w[:, :, None]
    else:
        shape = (neigh.shape[0], heads, width // heads)

        def score(rows):
            return jnp.einsum("bhd,hd->bh", rows.reshape(-1, heads,
                                                         shape[2]), proj)

        def payload(rows, w):
            return rows.reshape(-1, heads, shape[2]) * w[:, :, None]
    acc, s = conv._online_attend(table, idx, mask, el, shape, jnp.float32,
                                 score, payload)
    return acc / jnp.maximum(s, 1e-9)[:, :, None]


@pytest.mark.parametrize("fanout", [5, 40])
@pytest.mark.parametrize("mode,width", [("shared", 16), ("shared", 7),
                                        ("per_head", 12)])
def test_one_head_attend_and_its_gradients_match_jax(mode, width, fanout):
    """At one head: the forward at 1e-5 and the gradients w.r.t. the table,
    el_dst and the projection at 1e-4 against jax.vjp of the JAX function;
    40 picks a row span two of the kernel's 32-pick windows."""
    from xgnn_tpu_torch.ops.attend import gat_attend

    rng = np.random.default_rng(width + fanout)
    n, d = 40, 24
    table = rng.standard_normal((n, width)).astype(np.float32)
    neigh = _neigh(rng, d, fanout, n)
    el = rng.standard_normal((d, 1)).astype(np.float32)
    pshape = (width, 1) if mode == "shared" else (1, width)
    proj = (0.5 * rng.standard_normal(pshape)).astype(np.float32)
    g = rng.standard_normal((d, 1, width)).astype(np.float32)
    ref, vjp = jax.vjp(lambda t, e, p: _jax_attend(t, neigh, e, p, 1, mode),
                       jnp.asarray(table), jnp.asarray(el), jnp.asarray(proj))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (table, el, proj)]
    out = gat_attend(leaves[0], _t(neigh), leaves[1], leaves[2], mode)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    grads = torch.autograd.grad(out, leaves, _t(g))
    for name, a, b in zip(("table", "el_dst", "proj"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"gradient w.r.t. {name}")
    assert torch.all(grads[0][[2, 4]] == 0)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("fanout", [5, 15])
def test_attend_prefix_matches_jax(heads, fanout):
    """``gat_attend_prefix`` against ``el = h[:D] @ wl`` and the JAX attend:
    the output at 1e-5, the gradients w.r.t. h, wl and wr at 1e-4.  Src
    rows 2 and 4 lie in the prefix and no pick reaches them: their gradient
    is the prefix's alone."""
    from xgnn_tpu_torch.ops.attend import gat_attend_prefix

    rng = np.random.default_rng(heads * 10 + fanout)
    n, d, width = 50, 20, 16
    h = rng.standard_normal((n, width)).astype(np.float32)
    neigh = _neigh(rng, d, fanout, n, outside=False)
    wl, wr = (0.5 * rng.standard_normal((2, width, heads))).astype(np.float32)
    g = rng.standard_normal((d, heads, width)).astype(np.float32)

    def jfn(x, a, b):
        return _jax_attend(x, neigh, x[:d] @ a, b, heads, "shared")

    ref, vjp = jax.vjp(jfn, jnp.asarray(h), jnp.asarray(wl), jnp.asarray(wr))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (h, wl, wr)]
    out = gat_attend_prefix(leaves[0], _t(neigh), leaves[1], leaves[2])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    grads = torch.autograd.grad(out, leaves, _t(g))
    for name, a, b in zip(("h_src", "wl", "wr"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"gradient w.r.t. {name}")
    with torch.no_grad():
        again = gat_attend_prefix(_t(h), _t(neigh), _t(wl), _t(wr))
    assert torch.equal(again, out.detach())


def _graph_nodes(fn):
    """The names of every autograd node behind ``fn``."""
    seen, todo, names = set(), [fn], []
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(nxt for nxt, _ in node.next_functions)
    return names


@pytest.mark.parametrize("heads,in_dim,out_dim", [(1, 16, 16), (1, 12, 16),
                                                  (4, 16, 8), (8, 32, 8)])
def test_gat_conv_prefix_form_matches_flax(heads, in_dim, out_dim):
    """GATConv in shared mode on a local-id block takes the prefix form: no
    slice of ``h_src`` in its autograd graph (so no zero-filled gradient of
    ``h_src`` and no add after K5's sum).  Output at 1e-5; the gradients
    w.r.t. h_src, kernel, attn_l and attn_r at 1e-4 against jax.grad of
    flax GATConv with the same weights."""
    from xgnn_tpu.models.gnn import GATConv as JGATConv
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GATConv
    from xgnn_tpu_torch.types import Block

    n_src, d, fanout = 60, 20, 6
    seed = heads * 100 + in_dim
    rng = np.random.default_rng(seed)
    neigh = _neigh(rng, d, fanout, n_src, outside=False)
    jb = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                num_src=jnp.int32(n_src), dst_ids=None)
    pb = Block(neigh=_t(neigh), num_dst=torch.tensor(d, dtype=torch.int32),
               num_src=torch.tensor(n_src, dtype=torch.int32), dst_ids=None)
    h = rng.standard_normal((n_src, in_dim)).astype(np.float32)
    jconv = JGATConv(out_dim=out_dim, num_heads=heads, acc_limit=10**9,
                     mat_limit=10**9)
    params = jconv.init(jax.random.key(seed), jb, jnp.asarray(h))["params"]
    out_j = jconv.apply({"params": params}, jb, jnp.asarray(h))
    g = rng.standard_normal(out_j.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jconv.apply({"params": p}, jb, x) * g)

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(h))

    def state(tree):
        flat = params_from_flax({"GATConv_0": jax.tree.map(np.asarray, tree)})
        return {k[len("layers.0."):]: v for k, v in flat.items()}

    conv = GATConv(in_dim, out_dim, heads)
    conv.load_state_dict(state(params))
    ht = _t(h).requires_grad_(True)
    out = conv(pb, ht)
    assert not any("Slice" in name for name in _graph_nodes(out.grad_fn))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    torch.sum(out * _t(g)).backward()
    want = state(jg_p)
    for pname, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(),
                                   **GRAD_TOL,
                                   err_msg=f"gradient w.r.t. {pname}")
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg_h), **GRAD_TOL,
                               err_msg="gradient w.r.t. h_src")


def _per_pick_g_table(g_out, table, neigh, el, proj, m, s, mode, grad_dst):
    """The form the one-head backward replaced: a gradient row a pick,
    ``v_k = a_k g_out[b] + g_pre_k proj``, added by ``index_add_`` in pick
    order, then ``grad_dst``; with the aggregate of its terms' magnitudes
    in each element."""
    from xgnn_tpu_torch.ops.attend import (
        NEGATIVE_SLOPE,
        _pick_terms,
        attend_dot_plain,
    )

    d, fanout = neigh.shape
    u = proj[:, 0] if mode == "shared" else proj[0]
    dot = attend_dot_plain(g_out, table, neigh, el, proj, m, s, mode)
    den = torch.clamp(s, min=1e-9)
    g2 = g_out.reshape(d, -1)
    g_table = torch.zeros_like(table)
    mag = torch.zeros_like(table)
    for k in range(fanout):
        valid, _, pre, a, ga = _pick_terms(g_out, table, neigh, el, proj, m,
                                           den, mode, k)
        g_e = a * (ga - dot)
        g_pre = torch.where(pre >= 0, g_e, NEGATIVE_SLOPE * g_e)
        v = a * g2 + g_pre * u
        size = (a * g2).abs() + (g_pre * u).abs()
        col = torch.where(valid, neigh[:, k], 0)
        g_table.index_add_(0, col, torch.where(valid[:, None], v, 0.0))
        mag.index_add_(0, col, torch.where(valid[:, None], size, 0.0))
    if grad_dst is not None:
        g_table[:d] += grad_dst
        mag[:d] += grad_dst.abs()
    return g_table, mag


@pytest.mark.parametrize("mode,width,fanout,prefix", [
    ("shared", 16, 5, False), ("shared", 16, 5, True),
    ("shared", 9, 40, False), ("shared", 9, 40, True),
    ("per_head", 12, 10, False)])
def test_one_head_plain_g_table_equals_the_per_pick_form(mode, width, fanout,
                                                         prefix):
    """``attend_backward_plain`` at one head (K4's weighted sum of g_out by
    a, then ``(sum g_pre) * u``, then the prefix's ``g_el @ wl.T``) against
    the per-pick rows it replaced, within 1e-5 of the aggregate of the
    terms' magnitudes; rows no pick reaches hold exactly the prefix's
    gradient (or zero), and ``g_el`` and ``g_proj`` are those of the run
    without the table's gradient."""
    from xgnn_tpu_torch.ops.attend import (
        attend_backward_plain,
        attend_forward_plain,
    )

    rng = np.random.default_rng(width * fanout + prefix)
    n, d = 45, 30
    table = _t(rng.standard_normal((n, width)).astype(np.float32))
    neigh = _t(_neigh(rng, d, fanout, n, outside=not prefix))
    el = _t(rng.standard_normal((d, 1)).astype(np.float32))
    pshape = (width, 1) if mode == "shared" else (1, width)
    proj, wl = (_t(0.5 * rng.standard_normal(pshape).astype(np.float32))
                for _ in range(2))
    wl = wl if prefix else None
    _, m, s = attend_forward_plain(table, neigh, el, proj, mode)
    g_out = _t(rng.standard_normal((d, 1, width)).astype(np.float32))
    args = (g_out, table, neigh, el, proj, m, s, mode)
    g_table, g_el, g_proj = attend_backward_plain(*args, True, wl)
    none, g_el0, g_proj0 = attend_backward_plain(*args, False, wl)
    assert none is None
    assert torch.equal(g_el, g_el0) and torch.equal(g_proj, g_proj0)
    grad_dst = None if wl is None else g_el @ wl.T
    ref, mag = _per_pick_g_table(*args, grad_dst)
    assert torch.all((g_table - ref).abs() <= 1e-5 * mag + 1e-30)
    unreached = [2, 4] + list(range(16, n))
    want = torch.zeros((len(unreached), width))
    if grad_dst is not None:
        want[:2] = grad_dst[[2, 4]]
        want[2:d - 14] = grad_dst[16:]
    assert torch.equal(g_table[unreached], want)


def test_one_head_plain_backward_edge_cases():
    """D = 0 (the table's gradient is zero, with or without the prefix),
    and a block whose every pick is EMPTY or outside [0, N): zero
    gradients but the prefix's."""
    from xgnn_tpu_torch.ops.attend import (
        attend_backward_plain,
        attend_forward_plain,
    )

    rng = np.random.default_rng(3)
    n, width = 12, 8
    table = _t(rng.standard_normal((n, width)).astype(np.float32))
    proj, wl = (_t(rng.standard_normal((width, 1)).astype(np.float32))
                for _ in range(2))
    for d, bad in ((0, None), (4, EMPTY_KEY), (4, -1), (4, n)):
        neigh = torch.full((d, 5), EMPTY_KEY if bad is None else bad,
                           dtype=torch.int32)
        el = _t(rng.standard_normal((d, 1)).astype(np.float32))
        out, m, s = attend_forward_plain(table, neigh, el, proj, "shared")
        assert torch.all(out == 0)
        g_out = torch.ones((d, 1, width))
        g_table, g_el, g_proj = attend_backward_plain(
            g_out, table, neigh, el, proj, m, s, "shared", True, wl)
        assert torch.all(g_el == 0) and torch.all(g_proj == 0)
        assert torch.all(g_table == 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("prefix", [0, 7])
def test_fanout_backward_plain_rank1_order(weighted, prefix):
    """``fanout_backward_plain`` with ``c`` and ``u``: the weighted sum as
    without them, then ``(c summed from 0 over the row's picks in
    ascending k, then i) * u``, then ``grad_dst``, bit for bit."""
    from xgnn_tpu_torch.ops.fanout import fanout_backward_plain

    rng = np.random.default_rng(weighted * 10 + prefix)
    n, d, k, width = 30, 12, 6, 5
    neigh = _t(_neigh(rng, d, k, n))
    w = _t(rng.random((d, k)).astype(np.float32) + 0.5) if weighted else None
    gs = _t(rng.standard_normal((d, width)).astype(np.float32))
    c = _t(rng.standard_normal((d, k)).astype(np.float32))
    u = _t(rng.standard_normal(width).astype(np.float32))
    gd = (_t(rng.standard_normal((prefix, width)).astype(np.float32))
          if prefix else None)
    got = fanout_backward_plain(gs, neigh, w, n, gd, c=c, u=u)
    csum = torch.zeros(n)
    for kk in range(k):
        for i in range(d):
            r = int(neigh[i, kk])
            if 0 <= r < n:
                csum[r] = csum[r] + c[i, kk]
    want = fanout_backward_plain(gs, neigh, w, n) + csum[:, None] * u
    if gd is not None:
        want[:prefix] += gd
    assert torch.equal(got, want)
