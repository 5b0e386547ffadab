"""K5, GAT's edge-softmax aggregate, at 4 and 8 heads against the JAX
package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and the port: ``gat_attend`` and its three gradients (table, ``el_dst``
and the score projection) against ``GATConv._online_attend`` with the
aggregate-first score and payload, and ``GATConv`` with every parameter's
gradient against flax ``GATConv`` through ``convert.params_from_flax``.
On the CPU the wrappers take their plain PyTorch versions;
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` hold the CUDA
kernels to those versions on the card.  Also the identity the backward
rests on: ``sum_k a_k (g_out . row_k) / sum_k a_k`` equals ``g_out . out``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# float32 sums in other orders than XLA's, and the gradient's difference
# g_out . payload - dot keeping their rounding while the values cancel
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _neigh(rng, d, k, n, outside=True):
    """Picks with repeats, EMPTY, ids below 0 and past the table (with
    ``outside``), a dst row with no valid pick, one with a single valid pick
    and one whose picks all repeat one id."""
    neigh = rng.integers(0, min(n, 12), (d, k)).astype(np.int32)
    bad = rng.random((d, k))
    neigh[bad < 0.2] = EMPTY_KEY
    if outside:
        neigh[(bad >= 0.2) & (bad < 0.25)] = -4
        neigh[(bad >= 0.25) & (bad < 0.3)] = n + 3
    neigh[5] = EMPTY_KEY
    neigh[6] = EMPTY_KEY
    neigh[6, k // 2] = 3
    neigh[7] = 9
    return neigh


def _case(seed, heads, width, k, n=40, d=24):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, width)).astype(np.float32)
    el = rng.standard_normal((d, heads)).astype(np.float32)
    wr = (0.5 * rng.standard_normal((width, heads))).astype(np.float32)
    g = rng.standard_normal((d, heads, width)).astype(np.float32)
    return table, _neigh(rng, d, k, n), el, wr, g


def _jax_attend(table, neigh, el, wr, heads):
    """JAX's aggregate-first attend: ``GATConv._online_attend`` with its
    shared score (``rows @ wr``) and payload (the whole row per head),
    normalised as ``GATConv`` normalises it."""
    from xgnn_tpu.models.gnn import GATConv as JGATConv

    n, width = table.shape
    mask = (neigh >= 0) & (neigh < n)
    idx = jnp.where(mask, neigh, 0)
    conv = JGATConv(out_dim=1, num_heads=heads)
    acc, s = conv._online_attend(
        table, idx, mask, el, (neigh.shape[0], heads, width), jnp.float32,
        lambda rows: rows @ wr,
        lambda rows, w: rows[:, None, :] * w[:, :, None])
    return acc / jnp.maximum(s, 1e-9)[:, :, None]


@pytest.mark.parametrize("fanout", [5, 15])
@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("heads", [4, 8])
def test_gat_attend_and_its_gradients_match_jax(heads, width, fanout):
    """Forward at 1e-5, the gradients w.r.t. the table, el_dst and wr at
    1e-4, against jax.vjp of the JAX function."""
    from xgnn_tpu_torch.ops.attend import SHARED, gat_attend

    table, neigh, el, wr, g = _case(heads * 100 + width + fanout, heads,
                                    width, fanout)
    ref, vjp = jax.vjp(lambda t, e, w: _jax_attend(t, neigh, e, w, heads),
                       jnp.asarray(table), jnp.asarray(el), jnp.asarray(wr))
    ref_grads = vjp(jnp.asarray(g))
    leaves = [_t(a).requires_grad_(True) for a in (table, el, wr)]
    out = gat_attend(leaves[0], _t(neigh), leaves[1], leaves[2], SHARED)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **FWD_TOL)
    assert np.all(out.detach().numpy()[5] == 0)
    grads = torch.autograd.grad(out, leaves, _t(g))
    for name, a, b in zip(("table", "el_dst", "wr"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=f"gradient w.r.t. {name}")


def _blocks(seed, n_src, d, k):
    """A local-id block for JAX and the port (h_src an activation, so its
    gradient is the table's).  Its invalid picks are EMPTY: a JAX block
    masks only those."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.types import Block

    neigh = _neigh(np.random.default_rng(seed), d, k, n_src, outside=False)
    jb = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                num_src=jnp.int32(n_src), dst_ids=None)
    pb = Block(neigh=_t(neigh), num_dst=torch.tensor(d, dtype=torch.int32),
               num_src=torch.tensor(n_src, dtype=torch.int32), dst_ids=None)
    return jb, pb


@pytest.mark.parametrize("fanout", [5, 15])
@pytest.mark.parametrize("in_dim", [16, 32])
@pytest.mark.parametrize("heads", [4, 8])
def test_gat_conv_at_many_heads_matches_flax(heads, in_dim, fanout):
    """GATConv in shared mode (in <= H*d): K5 carries the attend, the
    einsum the transform.  Output at 1e-5; every parameter's gradient and
    h_src's at 1e-4, against flax GATConv with the same weights."""
    from xgnn_tpu.models.gnn import GATConv as JGATConv
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GATConv

    out_dim, n_src, d = 8, 60, 20
    seed = heads * 100 + in_dim + fanout
    jb, pb = _blocks(seed, n_src, d, fanout)
    h = np.random.default_rng(seed + 1).standard_normal(
        (n_src, in_dim)).astype(np.float32)
    jconv = JGATConv(out_dim=out_dim, num_heads=heads, acc_limit=10**9,
                     mat_limit=10**9)
    params = jconv.init(jax.random.key(seed), jb, jnp.asarray(h))["params"]
    out_j = jconv.apply({"params": params}, jb, jnp.asarray(h))
    g = np.random.default_rng(seed + 2).standard_normal(
        out_j.shape).astype(np.float32)

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


@pytest.mark.parametrize("mode,heads", [("shared", 1), ("shared", 4),
                                        ("shared", 8), ("per_head", 2)])
def test_dot_without_out_equals_g_out_dot_out(mode, heads):
    """``attend_dot_plain``: sum_k a_k (g_out . payload_k) / sum_k a_k from
    the forward's m and s, against g_out . out at 1e-5."""
    from xgnn_tpu_torch.ops.attend import (
        attend_dot_plain,
        attend_forward_plain,
    )

    width = 24
    table, neigh, el, wr, _ = _case(heads + 7, heads, width, 6)
    proj = (wr if mode == "shared"
            else wr.T.reshape(heads, width)[:, :width // heads])
    args = (_t(table), _t(neigh), _t(el), _t(np.ascontiguousarray(proj)))
    out, m, s = attend_forward_plain(*args, mode)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    dot = attend_dot_plain(g_out, *args, m, s, mode)
    torch.testing.assert_close(dot, (g_out * out).sum(-1), **FWD_TOL)
    assert torch.all(dot[5] == 0)
