"""K11's steps against the JAX store's, on the CPU, exactly.

The port's ``compact_mask_positions`` against JAX's (K10's function, which
the card computes inside K11's split); ``tiered_split_plain`` against
``_split_kernel``; ``tiered_combine_plain`` against ``_combine_kernel``;
and the composed ``tiered_extract_plain`` against
``TieredFeatureSource.extract`` in both of JAX's miss modes.  The inputs
are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402


def _ids(rng, num_node, n, num_input, empty_frac=0.2):
    """``n`` ids: the first ``num_input`` distinct draws from the graph with
    some EMPTY, the rest valid ids that ``num_input`` must hide."""
    ids = np.full(n, EMPTY_KEY, np.int32)
    ids[:num_input] = rng.choice(num_node, num_input, replace=False)
    ids[:num_input][rng.random(num_input) < empty_frac] = EMPTY_KEY
    ids[num_input:] = rng.integers(0, num_node, n - num_input)
    return ids


def _sources(small_ds, pct, seed):
    """The JAX store and the port's (on the CPU) over one ranking."""
    from xgnn_tpu.store.feature_store import TieredFeatureSource as JTiered
    from xgnn_tpu_torch.store import TieredFeatureSource

    rng = np.random.default_rng(seed)
    feat = np.asarray(small_ds.feat)
    ranking = rng.permutation(small_ds.num_node).astype(np.int32)
    return (rng, feat, JTiered(feat, ranking, pct),
            TieredFeatureSource(feat, ranking, pct, "cpu"))


@pytest.mark.parametrize("n", [1, 777, 4096])
@pytest.mark.parametrize("kind", ["none", "some", "all"])
@pytest.mark.parametrize("cap", ["below", "at"])
def test_compact_mask_positions_matches_jax(n, kind, cap):
    from xgnn_tpu.ops.unique import compact_mask_positions as jcompact
    from xgnn_tpu_torch.ops.unique import compact_mask_positions

    rng = np.random.default_rng(n + len(kind))
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "some": rng.random(n) < 0.3}[kind]
    out_cap = max(n // 3, 1) if cap == "below" else n
    want = np.asarray(jcompact(jnp.asarray(mask), out_cap))
    got = compact_mask_positions(torch.from_numpy(mask), out_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pct,num_input", [(0.2, 700), (0.5, 1024),
                                           (0.05, 0), (0.0, 900)])
def test_tiered_split_plain_matches_jax(small_ds, pct, num_input):
    """The miss list (positions and ids, in order), the counts and the hit
    rows equal ``_split_kernel``'s; every other row of ``out`` is zero
    (JAX's spread pad rows are zero too, but not the contract)."""
    from xgnn_tpu.store.feature_store import _split_kernel
    from xgnn_tpu_torch.ops.tiered import tiered_split_plain

    rng, feat, jsrc, src = _sources(small_ds, pct, int(pct * 100) + 1)
    ids = _ids(rng, small_ds.num_node, 1024, num_input)
    cached, jmiss_ids, jmiss_pos, jnum_miss, jnum_hit = _split_kernel(
        jsrc.posmap, jsrc.cache_feat, jnp.asarray(ids), num_input)
    out, counts, miss_pos, miss_ids = tiered_split_plain(
        torch.from_numpy(ids), num_input, src.posmap, src.cache_feat,
        src.feat_host)
    nm = int(jnum_miss)
    assert counts.tolist() == [int(jnum_hit), nm]
    np.testing.assert_array_equal(miss_pos.numpy()[:nm],
                                  np.asarray(jmiss_pos)[:nm])
    np.testing.assert_array_equal(miss_ids.numpy()[:nm],
                                  np.asarray(jmiss_ids)[:nm])
    # the padding: positions n, ids EMPTY
    assert (miss_pos.numpy()[nm:] == 1024).all()
    assert (miss_ids.numpy()[nm:] == EMPTY_KEY).all()
    posmap = np.asarray(jsrc.posmap)
    live = np.arange(1024) < num_input
    hit = live & (ids != EMPTY_KEY)
    hit[hit] = posmap[ids[hit]] != EMPTY_KEY
    assert int(hit.sum()) == int(jnum_hit)
    np.testing.assert_array_equal(out.numpy()[hit], np.asarray(cached)[hit])
    assert not out.numpy()[~hit].any()


def test_tiered_split_plain_all_miss_form_matches_jax(small_ds):
    """With no posmap every valid id is a miss: JAX's split over a posmap
    with no cached row."""
    from xgnn_tpu.store.feature_store import _split_kernel
    from xgnn_tpu_torch.ops.tiered import tiered_split_plain

    rng, feat, jsrc, src = _sources(small_ds, 0.0, 5)
    ids = _ids(rng, small_ds.num_node, 600, 450)
    _, jmiss_ids, jmiss_pos, jnum_miss, jnum_hit = _split_kernel(
        jsrc.posmap, jsrc.cache_feat, jnp.asarray(ids), 450)
    out, counts, miss_pos, miss_ids = tiered_split_plain(
        torch.from_numpy(ids), 450, None, None, src.feat_host)
    nm = int(jnum_miss)
    assert int(jnum_hit) == 0 and counts.tolist() == [0, nm]
    assert nm == int((ids[:450] != EMPTY_KEY).sum())
    np.testing.assert_array_equal(miss_pos.numpy()[:nm],
                                  np.asarray(jmiss_pos)[:nm])
    np.testing.assert_array_equal(miss_ids.numpy()[:nm],
                                  np.asarray(jmiss_ids)[:nm])
    assert not out.any()


@pytest.mark.parametrize("pct,num_input", [(0.2, 700), (0.5, 1024),
                                           (0.05, 0)])
def test_tiered_combine_plain_matches_jax(small_ds, pct, num_input):
    """The same split outputs and miss rows into both combines (JAX's miss
    rows a power-of-two bucket with junk past ``num_miss``)."""
    from xgnn_tpu.store.feature_store import _bucket, _combine_kernel, \
        _split_kernel
    from xgnn_tpu_torch.ops.tiered import tiered_combine_plain

    rng, feat, jsrc, _ = _sources(small_ds, pct, int(pct * 100) + 2)
    ids = _ids(rng, small_ds.num_node, 1024, num_input)
    cached, miss_ids, miss_pos, num_miss, _ = _split_kernel(
        jsrc.posmap, jsrc.cache_feat, jnp.asarray(ids), num_input)
    nm = int(num_miss)
    bucket = min(_bucket(max(nm, 1)), 1024)
    rows = rng.standard_normal((bucket, feat.shape[1])).astype(np.float32)
    rows[:nm] = feat[np.asarray(miss_ids)[:nm]]
    cached_np, pos_np = np.array(cached), np.array(miss_pos)
    want = np.asarray(_combine_kernel(cached, jnp.asarray(rows), miss_pos,
                                      num_miss))
    got = tiered_combine_plain(torch.from_numpy(cached_np),
                               torch.from_numpy(rows[:nm]),
                               torch.from_numpy(pos_np), nm)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("miss_mode", ["fixed", "dynamic"])
@pytest.mark.parametrize("pct,num_input", [(0.2, 700), (0.5, 1000),
                                           (0.05, 0), (0.9, 1024)])
def test_tiered_extract_plain_composition_matches_jax(small_ds, miss_mode,
                                                      pct, num_input):
    """The split, the host gather and the combine composed: every row equal
    to JAX's ``extract`` (zero past ``num_input``), and the counts."""
    from xgnn_tpu.store.feature_store import TieredFeatureSource as JTiered
    from xgnn_tpu_torch.ops.tiered import (
        tiered_direct,
        tiered_extract_plain,
        tiered_split,
    )
    from xgnn_tpu_torch.store import TieredFeatureSource

    rng = np.random.default_rng(int(pct * 100) + 3)
    feat = np.asarray(small_ds.feat)
    ranking = rng.permutation(small_ds.num_node).astype(np.int32)
    jsrc = JTiered(feat, ranking, pct,
                   miss_cap=1024 if miss_mode == "fixed" else None)
    src = TieredFeatureSource(feat, ranking, pct, "cpu")
    ids = _ids(rng, small_ds.num_node, 1024, num_input)
    jout, jinfo = jsrc.extract(jnp.asarray(ids), num_input)
    tids = torch.from_numpy(ids)
    out, counts = tiered_extract_plain(tids, num_input, src.posmap,
                                       src.cache_feat, src.feat_host)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    nh, nm = counts.tolist()
    if miss_mode == "fixed":
        assert (nh, nm) == (int(jinfo["num_hit"]), int(jinfo["num_miss"]))
    else:
        assert jinfo["miss_bytes"] == nm * feat.shape[1] * 4
        assert jinfo["hit_rate"] == nh / max(nh + nm, 1)
    # the wrappers on CPU tensors take the same plain steps
    s_out, s_counts, s_pos, s_ids = tiered_split(
        tids, num_input, src.posmap, src.cache_feat, src.host)
    assert torch.equal(s_counts, counts)
    assert torch.equal(tiered_direct(s_out, s_ids, s_pos, s_counts,
                                     src.host), out)
