"""The port's GCN and GAT against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``xgnn_tpu_torch``: K7 (``pick_multiplicity``), K5
(``gat_attend``, against a plain softmax written out here), ``GCNConv`` and
``GATConv`` under every JAX form, and the whole ``GNN``.  On the CPU the
kernel wrappers take their plain PyTorch versions; ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold the CUDA kernels to those versions
on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

# float32 sums in other orders than XLA's: 1e-4 relative, 1e-5 absolute
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ K7 degree
def _picks(rng, shape, num_rows, empty=0.3):
    ids = rng.integers(0, num_rows, shape).astype(np.int32)
    ids[rng.random(shape) < empty] = EMPTY_KEY
    return ids


@pytest.mark.parametrize("shape,num_rows", [((40, 5), 30), ((7, 15), 9),
                                            ((300, 3), 1000), ((1, 1), 4)])
def test_pick_multiplicity_matches_jax(shape, num_rows):
    """Counts over the whole flattened block: ids repeat across rows."""
    from xgnn_tpu.ops.degree import pick_multiplicity as jax_mult
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    ids = _picks(np.random.default_rng(num_rows), shape, num_rows)
    ref = np.asarray(jax_mult(jnp.asarray(ids)))
    out, _ = pick_multiplicity(_t(ids), num_rows)
    assert out.dtype == torch.int32 and out.shape == shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_pick_multiplicity_all_empty_block():
    from xgnn_tpu.ops.degree import pick_multiplicity as jax_mult
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    ids = np.full((6, 4), EMPTY_KEY, np.int32)
    out, _ = pick_multiplicity(_t(ids), 10)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_mult(ids)))
    assert int(out.abs().sum()) == 0


def test_pick_multiplicity_outside_the_rows_counts_zero():
    """Ids outside [0, num_rows) other than EMPTY are outside the contract:
    the port counts them 0, and the rest as the JAX function counts the
    block with those ids made EMPTY."""
    from xgnn_tpu.ops.degree import pick_multiplicity as jax_mult
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    rng = np.random.default_rng(5)
    ids = _picks(rng, (50, 6), 20)
    ids[::7, 1] = -3
    ids[::5, 2] = 20
    out = pick_multiplicity(_t(ids), 20)[0].numpy()
    inside = np.where((ids >= 0) & (ids < 20), ids, EMPTY_KEY)
    np.testing.assert_array_equal(out, np.asarray(jax_mult(inside)))


def _k7_edge_picks(case):
    """Pick blocks of K7's edge cases: a hub id picked past 2^16 times, a
    star (every pick one id), a chain (every id once), EMPTY runs."""
    rng = np.random.default_rng(len(case))
    if case == "hub past 2^16":
        ids = _picks(rng, (40_000, 3), 5000, empty=0.1)
        ids[ids == 77] = 78
        ids[:, 1] = 77
        ids[:30_000, 2] = 77
        return ids, 5000
    if case == "star":
        return np.full((300, 7), 3, np.int32), 4
    if case == "chain":
        return np.arange(4096, dtype=np.int32).reshape(512, 8), 4096
    if case == "empty runs":
        ids = _picks(rng, (64, 33), 20, empty=0.0)
        ids[::3] = EMPTY_KEY
        ids[:, ::5] = EMPTY_KEY
        return ids, 20
    raise ValueError(case)


@pytest.mark.parametrize("case", ["hub past 2^16", "star", "chain",
                                  "empty runs"])
def test_pick_multiplicity_edge_cases_match_jax(case):
    """The counts equal JAX's; the weights equal the plain torch
    expression bit for bit, and JAX's lax.rsqrt within 2 float32 ulps
    (two rsqrt implementations)."""
    from xgnn_tpu.ops.degree import pick_multiplicity as jax_mult
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    ids, rows = _k7_edge_picks(case)
    ref = np.asarray(jax_mult(jnp.asarray(ids)))
    cnt, w = pick_multiplicity(_t(ids), rows)
    np.testing.assert_array_equal(cnt.numpy(), ref)
    assert torch.equal(w, torch.rsqrt(torch.clamp(cnt.float(), min=1.0)))
    jw = np.asarray(jax.lax.rsqrt(jnp.maximum(jnp.asarray(ref, jnp.float32),
                                              1.0)))
    np.testing.assert_array_max_ulp(w.numpy(), jw, maxulp=2)
    if case == "hub past 2^16":
        assert int(cnt[0, 1]) == 70_000


@pytest.mark.parametrize("num_rows", [0, 1])
def test_pick_multiplicity_with_zero_or_one_row(num_rows):
    """With no row every pick counts 0; with one, row 0's picks count
    each other, as JAX counts the block with the other ids made EMPTY."""
    from xgnn_tpu.ops.degree import pick_multiplicity as jax_mult
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    ids = np.random.default_rng(num_rows).integers(-2, 3, 97).astype(
        np.int32)
    out = pick_multiplicity(_t(ids), num_rows)[0].numpy()
    inside = np.where((ids >= 0) & (ids < num_rows), ids, EMPTY_KEY)
    np.testing.assert_array_equal(out, np.asarray(jax_mult(inside)))
    assert int(out.max()) == (0 if num_rows == 0 else int((ids == 0).sum()))


def test_pick_multiplicity_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.degree import pick_multiplicity

    ids = torch.zeros((4, 3), dtype=torch.int32)
    for args in ((ids.long(), 5), (ids.t(), 5), (ids, -1)):
        with pytest.raises(ValueError):
            pick_multiplicity(*args)


# ---------------------------------------------------------- K5 attend
def _attend_reference(table, neigh, el_dst, proj, mode):
    """A plain masked softmax over the materialised picks (a different
    formulation from the online loop of the plain version)."""
    n, width = table.shape
    valid = (neigh >= 0) & (neigh < n)
    rows = table[torch.where(valid, neigh, 0).long()]  # (D, K, W)
    d, k = neigh.shape
    h = el_dst.shape[1]
    if mode == "shared":
        score = rows @ proj  # (D, K, H)
        payload = rows[:, :, None, :].expand(d, k, h, width)
    else:
        payload = rows.reshape(d, k, h, -1)
        score = (payload * proj).sum(-1)
    e = torch.nn.functional.leaky_relu(el_dst[:, None, :] + score, 0.2)
    e = torch.where(valid[:, :, None], e, -torch.inf)
    a = torch.nan_to_num(torch.softmax(e, dim=1)) * valid[:, :, None]
    return (a[..., None] * payload).sum(1)


def _attend_case(seed, mode, heads, width, n=40, d=24, k=6):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, width)).astype(np.float32)
    neigh = rng.integers(0, 12, (d, k)).astype(np.int32)  # many repeats
    bad = rng.random((d, k))
    neigh[bad < 0.2] = EMPTY_KEY
    neigh[(bad >= 0.2) & (bad < 0.25)] = -4
    neigh[(bad >= 0.25) & (bad < 0.3)] = n + 3
    neigh[5] = EMPTY_KEY  # a dst row with no valid pick
    el = rng.standard_normal((d, heads)).astype(np.float32)
    if mode == "shared":
        proj = rng.standard_normal((width, heads)).astype(np.float32)
    else:
        proj = rng.standard_normal((heads, width // heads)).astype(np.float32)
    return table, neigh, el, proj


@pytest.mark.parametrize("mode,heads,width", [
    ("shared", 1, 8), ("shared", 3, 5), ("per_head", 1, 7),
    ("per_head", 4, 12),
])
def test_gat_attend_and_grads_match_a_plain_softmax(mode, heads, width):
    """Forward and every gradient of the Function (plain forward and plain
    backward on the CPU) against autograd through the materialised softmax,
    with EMPTY and out-of-range picks and a row with no valid pick."""
    from xgnn_tpu_torch.ops.attend import gat_attend

    table, neigh, el, proj = _attend_case(heads * width, mode, heads, width)
    g = np.random.default_rng(1).standard_normal(
        (neigh.shape[0], heads, width if mode == "shared" else width // heads)
    ).astype(np.float32)
    leaves = [_t(a).requires_grad_(True) for a in (table, el, proj)]
    out = gat_attend(leaves[0], _t(neigh), leaves[1], leaves[2], mode)
    grads = torch.autograd.grad(out, leaves, _t(g))
    ref_leaves = [_t(a).requires_grad_(True) for a in (table, el, proj)]
    ref = _attend_reference(ref_leaves[0], _t(neigh), ref_leaves[1],
                            ref_leaves[2], mode)
    ref_grads = torch.autograd.grad(ref, ref_leaves, _t(g))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               **tol)
    assert torch.all(out[5] == 0)
    for name, a, b in zip(("table", "el_dst", "proj"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol,
                                   err_msg=f"gradient w.r.t. {name}")
    assert torch.all(grads[1][5] == 0)


def test_gat_attend_table_without_gradient():
    """The feature table of layer 0 needs none: the backward still gives
    ``g_el_dst`` and ``g_proj``."""
    from xgnn_tpu_torch.ops.attend import gat_attend

    table, neigh, el, proj = _attend_case(2, "shared", 2, 8)
    e, p = _t(el).requires_grad_(True), _t(proj).requires_grad_(True)
    out = gat_attend(_t(table), _t(neigh), e, p, "shared")
    ge, gp = torch.autograd.grad(out.square().sum(), (e, p))
    e2, p2 = _t(el).requires_grad_(True), _t(proj).requires_grad_(True)
    ref = _attend_reference(_t(table), _t(neigh), e2, p2, "shared")
    re, rp = torch.autograd.grad(ref.square().sum(), (e2, p2))
    np.testing.assert_allclose(ge.numpy(), re.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), rp.numpy(), rtol=1e-5, atol=1e-5)


def test_gat_attend_limits_mirror_the_kernel():
    """``_check``'s limits are the constants ``fits()`` in
    ``csrc/attend.cu`` tests, so the CPU path refuses what the card does."""
    import re
    from pathlib import Path

    from xgnn_tpu_torch.ops import attend

    src = (Path(attend.__file__).parent.parent / "csrc"
           / "attend.cu").read_text()
    consts = {name: int(v) for name, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kMaxHeads"], consts["kMaxWidth"], consts["kMaxRow"]) == (
        attend.MAX_HEADS, attend.MAX_WIDTH, attend.MAX_ROW)
    fits = src[src.index("bool fits("):]
    assert "nh > kMaxHeads || width > kMaxWidth" in fits
    assert "hp * width <= kMaxRow" in fits


def test_gat_attend_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.attend import gat_attend

    table = torch.zeros((10, 8))
    neigh = torch.zeros((3, 2), dtype=torch.int32)
    el = torch.zeros((3, 2))
    wr = torch.zeros((8, 2))
    assert gat_attend(table, neigh, el, wr, "shared").shape == (3, 2, 8)
    assert gat_attend(table, neigh, el, torch.zeros((2, 4)),
                      "per_head").shape == (3, 2, 4)
    bad = [
        (table.double(), neigh, el, wr, "shared"),
        (table, neigh.long(), el, wr, "shared"),
        (table, neigh, el[:2], wr, "shared"),  # el_dst rows != dst rows
        (table, neigh, el, wr[:7], "shared"),  # proj does not fit the table
        (table, neigh, el, torch.zeros((2, 3)), "per_head"),  # 2 * 3 != 8
        (table, neigh, el, wr.t().contiguous().t(), "shared"),
        (table, neigh, el, wr, "contraction"),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            gat_attend(*args)
    # past what the kernel keeps in registers: 8 heads of 512, 9 heads
    wide = torch.zeros((10, 512))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gat_attend(wide, neigh, torch.zeros((3, 8)), torch.zeros((512, 8)),
                   "shared")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gat_attend(torch.zeros((10, 9)), neigh, torch.zeros((3, 9)),
                   torch.zeros((9, 1)), "per_head")
    # 5 heads count as 8: 8 x 300 floats is past 2048
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gat_attend(torch.zeros((10, 300)), neigh, torch.zeros((3, 5)),
                   torch.zeros((300, 5)), "shared")


# --------------------------------------------------------- conv layers
def _blocks(seed, direct, n_src, d=20, k=5):
    """A JAX block and the port's: repeats across rows, EMPTY picks, a dst
    row with no valid pick; a direct-extract block's dst ids include EMPTY
    and ``neigh`` holds ids into the whole table."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.types import Block

    rng = np.random.default_rng(seed)
    neigh = _picks(rng, (d, k), n_src if direct else min(n_src, 3 * d),
                   empty=0.25)
    neigh[3] = EMPTY_KEY
    dst_ids = None
    if direct:
        dst_ids = rng.integers(0, n_src, d).astype(np.int32)
        dst_ids[-2:] = EMPTY_KEY
    jb = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                num_src=jnp.int32(n_src),
                dst_ids=None if dst_ids is None else jnp.asarray(dst_ids))
    pb = Block(neigh=_t(neigh), num_dst=torch.tensor(d, dtype=torch.int32),
               num_src=torch.tensor(n_src, dtype=torch.int32),
               dst_ids=None if dst_ids is None else _t(dst_ids))
    return jb, pb


def _layer_state(name, params):
    from xgnn_tpu_torch.convert import params_from_flax

    state = params_from_flax({f"{name}_0": jax.tree.map(np.asarray, params)})
    return {k[len("layers.0."):]: v for k, v in state.items()}


def _check_conv(jconv, conv, name, direct, width, seed):
    """Forward, the gradient w.r.t. every parameter and (on a local-id
    block, whose h_src is an activation) w.r.t. h_src, against flax."""
    n_src = 60
    jb, pb = _blocks(seed, direct, n_src)
    h = np.random.default_rng(seed + 1).standard_normal(
        (n_src, width)).astype(np.float32)
    params = jconv.init(jax.random.key(seed), jb, jnp.asarray(h))["params"]
    out_j = jconv.apply({"params": params}, jb, jnp.asarray(h))
    g = np.random.default_rng(seed + 2).standard_normal(
        out_j.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jconv.apply({"params": p}, jb, x) * g)

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(h))
    conv.load_state_dict(_layer_state(name, params))
    ht = _t(h).requires_grad_(not direct)
    out = conv(pb, ht)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    torch.sum(out * _t(g)).backward()
    want = _layer_state(name, jg_p)
    for pname, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(), **TOL,
                                   err_msg=f"gradient w.r.t. {pname}")
    if not direct:
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg_h), **TOL,
                                   err_msg="gradient w.r.t. h_src")


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("in_dim,out_dim", [(8, 16), (16, 16), (16, 4)])
def test_gcn_conv_matches_flax(direct, in_dim, out_dim):
    """Aggregate first (in <= out) and transform first (in > out)."""
    from xgnn_tpu.models.gnn import GCNConv as JGCNConv
    from xgnn_tpu_torch.models.gnn import GCNConv

    _check_conv(JGCNConv(out_dim=out_dim), GCNConv(in_dim, out_dim),
                "GCNConv", direct, in_dim, in_dim + out_dim)


# every JAX form of GATConv, forced as tests/test_torch_parity.py forces them
_GAT_FORMS = [
    (1, 8, 10**9, 10**9, "aggregate-first"),
    (8, 8, 10**9, 10**9, "aggregate-first, 8 heads"),
    (8, 8, 0, 10**9, "contraction"),
    (8, 8, 0, 0, "per-pick"),
    (1, 2, 10**9, 10**9, "transform-first"),
    (2, 3, 10**9, 10**9, "transform-first, 2 heads"),
]


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("heads,out_dim,acc_limit,mat_limit,form", _GAT_FORMS,
                         ids=[f[-1] for f in _GAT_FORMS])
def test_gat_conv_matches_flax_in_every_form(direct, heads, out_dim,
                                             acc_limit, mat_limit, form):
    """The port computes every form through K5 (shared mode when in <= H*d,
    per-head mode otherwise)."""
    from xgnn_tpu.models.gnn import GATConv as JGATConv
    from xgnn_tpu.models.gnn import gat_select_path
    from xgnn_tpu_torch.models.gnn import GATConv

    in_dim = 8
    if in_dim <= heads * out_dim:
        path = gat_select_path(20, 5, in_dim, heads, out_dim, acc_limit,
                               mat_limit)
        assert path.replace("_", "-") in form
    jconv = JGATConv(out_dim=out_dim, num_heads=heads, acc_limit=acc_limit,
                     mat_limit=mat_limit)
    _check_conv(jconv, GATConv(in_dim, out_dim, heads), "GATConv", direct,
                in_dim, heads * 10 + out_dim)


# ------------------------------------------------------------ whole GNN
def _jax_batch(ds, direct, fanout, seed):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.sampler import Sampler as JSampler
    from xgnn_tpu.types import Graph as JGraph

    cfg = JConfig(batch_size=48, fanout=fanout, num_layer=len(fanout))
    sampler = JSampler(JGraph.from_dataset(ds), cfg, direct_extract=direct)
    seeds = np.asarray(ds.train_set[:48], np.int32)
    return sampler.sample(jnp.asarray(seeds), 48, jax.random.key(seed))


def _port_blocks(jbatch):
    from xgnn_tpu_torch.types import Block

    return [Block(neigh=_t(b.neigh), num_dst=_t(b.num_dst),
                  num_src=_t(b.num_src),
                  dst_ids=None if b.dst_ids is None else _t(b.dst_ids))
            for b in jbatch.blocks]


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("conv,heads", [("gcn", 1), ("gat", 1), ("gat", 2)])
def test_gnn_matches_flax(small_ds, direct, conv, heads):
    """Three sampled layers, dropout 0: logits and every parameter's
    gradient against the flax ``GNN``."""
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GNN
    from xgnn_tpu_torch.ops.gather import gather_rows

    fanout = (5, 4, 3)
    jb = _jax_batch(small_ds, direct, fanout, seed=heads)
    feat = np.asarray(small_ds.feat, np.float32)
    x = feat if direct else gather_rows(_t(feat), _t(jb.input_nodes)).numpy()
    num_class = 8
    jmodel = JGNN(conv=conv, hidden_dim=16, out_dim=num_class, num_layers=3,
                  dropout=0.0, num_heads=heads)
    params = jmodel.init(jax.random.key(3), jb.blocks, jnp.asarray(x),
                         False)["params"]
    g = np.random.default_rng(1).standard_normal(
        (jb.blocks[-1].dst_cap, num_class)).astype(np.float32)
    nd = int(jb.num_output)

    def jloss(p):
        out = jmodel.apply({"params": p}, jb.blocks, jnp.asarray(x), False)
        return jnp.sum(out[:nd] * g[:nd]), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = GNN(x.shape[1], 16, num_class, 3, dropout=0.0, conv=conv,
                num_heads=heads)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    out = model(_port_blocks(jb), _t(x), train=True)
    torch.sum(out[:nd] * _t(g)[:nd]).backward()
    np.testing.assert_allclose(out.detach().numpy()[:nd],
                               np.asarray(ref)[:nd], **TOL)
    want = params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL,
                                   err_msg=f"gradient w.r.t. {name}")


# ----------------------------------------------------------------- init
def test_gat_init_is_flax_style_and_seeded():
    """flax's lecun_normal over the kernel (in, H, d) takes fan_in = H*in;
    glorot_uniform over attn (H, d) has the limit sqrt(6 / (H + d))."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.models import build_model

    cfg = RunConfig(model="gat", num_head=8, num_hidden=256, num_layer=2)
    a = build_model(cfg, 128, 47, torch.Generator().manual_seed(0))
    b = build_model(cfg, 128, 47, torch.Generator().manual_seed(0))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    layer = a.layers[0].requires_grad_(False)
    assert layer.kernel.shape == (128, 8, 32)
    std, want = float(layer.kernel.std()), (1 / (8 * 128)) ** 0.5
    assert abs(std - want) < 0.05 * want  # 0.03125
    assert float(layer.kernel.abs().max()) <= 2 * want / 0.8796 + 1e-6
    limit = (6 / (8 + 32)) ** 0.5
    for attn in (layer.attn_l, layer.attn_r):
        assert float(attn.abs().max()) <= limit
        assert abs(float(attn.std()) - limit / 3 ** 0.5) < 0.1 * limit
    assert not torch.equal(layer.attn_l, layer.attn_r)
    logits = a.layers[1].requires_grad_(False)
    assert logits.kernel.shape == (256, 1, 47)  # one head on the logits
    assert abs(float(logits.kernel.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5


def test_gcn_init_is_flax_style():
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.models import build_model

    model = build_model(RunConfig(model="gcn", num_hidden=256, num_layer=3),
                        128, 47, torch.Generator().manual_seed(1))
    w = model.layers[0].fc.weight.detach()
    assert w.shape == (256, 128)
    assert abs(float(w.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert all(torch.count_nonzero(layer.bias) == 0 for layer in model.layers)
    assert model.activation is torch.relu
