"""k-means and the IVF index of the PyTorch port against the JAX package's,
on the CPU.

The two packages draw their initial centroids from different generators
(the port's is a seeded ``torch.Generator``; the JAX package's Threefry),
so the Lloyd loop and the builds are held with the JAX package's init
injected into the port (its private ``_init_centroids``), computed here
with ``jax.random.choice`` as ``kmeans_fit`` computes it. On the CPU
``index_add_`` adds in row order, as XLA's scatter does: centroids agree
within 1e-5 and assignments exactly. A build may differ only where a row
lies within 1e-6 of two centroids; such rows are counted. Search from a
given state gives equal ids and scores within 1e-6, whichever package
built it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.index import policy as jax_policy
from optimized_rag_tpu.index.ivf import IVFIndex as JaxIVF
from optimized_rag_tpu.index.snapshot import (
    load_state as jax_load_state, save_state as jax_save_state)
from optimized_rag_tpu.ops import kmeans as jk
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.index import policy
from optimized_rag_tpu_torch.index.ivf import IVFIndex
from optimized_rag_tpu_torch.index.snapshot import load_state, save_state
from optimized_rag_tpu_torch.ops import kmeans as pk

torch.set_num_threads(2)

SIM_TOL = 1e-6            # float32 products in two summation orders
CENT_TOL = 1e-5           # centroids after a few Lloyd steps
NEAR_TIE = 1e-6           # a row this close to two centroids may move
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(seed, n=2048, d=32, centers=32, noise=0.3):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _skewed(seed):
    """tests/test_index.py's skewed data: half the points near one
    center."""
    rng = np.random.default_rng(seed)
    hot = rng.standard_normal(16).astype(np.float32)
    pts = np.concatenate([
        hot + 0.05 * rng.standard_normal((500, 16)).astype(np.float32),
        rng.standard_normal((500, 16)).astype(np.float32)])
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def _jax_init(n, c, seed, valid=None):
    """The indices ``kmeans_fit`` of the JAX package draws its initial
    centroids from."""
    probs = (jnp.ones((n,), jnp.float32) if valid is None
             else jnp.asarray(valid).astype(jnp.float32))
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (c,),
                                        p=probs))


def _inject(monkeypatch, idx):
    monkeypatch.setattr(pk, "_init_centroids",
                        lambda pts, c, seed, valid: pts[torch.as_tensor(
                            np.asarray(idx, np.int64))])


def _held_build(port, ref, emb64):
    """A port build against the JAX build of the same rows: starts, counts,
    window, sort permutation and sorted rows equal, except where a row lies
    within NEAR_TIE of two centroids (the JAX centroids, in float64).
    Sorted bfloat16 rows may differ by one bfloat16 step where the two
    float32 normalisations differ by an ulp at a rounding boundary.
    Returns the number of rows that moved."""
    ps, js = port.state_dict(), ref.state_dict()
    np.testing.assert_allclose(ps["centroids"], np.asarray(js["centroids"]),
                               atol=CENT_TOL, rtol=0)
    assert ps["window"] == js["window"]
    assert ps["num_clusters_built"] == js["num_clusters_built"]

    def assignment(s):
        a = np.empty(int(s["size"]), np.int64)
        a[np.asarray(s["perm"])] = np.repeat(
            np.arange(len(s["counts"])), np.asarray(s["counts"]))
        return a
    a_p, a_j = assignment(ps), assignment(js)
    moved = np.flatnonzero(a_p != a_j)
    cents = np.asarray(js["centroids"], np.float64)
    sims = emb64[moved] @ cents.T
    gap = np.abs(sims[np.arange(len(moved)), a_p[moved]]
                 - sims[np.arange(len(moved)), a_j[moved]])
    assert (gap <= NEAR_TIE).all(), (moved, gap)
    if not len(moved):
        for key in ("starts", "counts", "perm"):
            np.testing.assert_array_equal(np.asarray(ps[key]),
                                          np.asarray(js[key]))
        want = np.asarray(js["sorted_emb"]).astype(np.float32)
        step = (0.0 if port._sorted_emb.dtype == torch.float32
                else 2.0 ** -7)
        np.testing.assert_allclose(ps["sorted_emb"], want, atol=SIM_TOL,
                                   rtol=step)
        assert (ps["sorted_emb"] != want).mean() < (1e-3 if step else 1.0)
    return len(moved)


def _same_search(port, ref, q, k, nprobe):
    s_p, i_p = port.search(q, k, nprobe=nprobe)
    s_j, i_j = ref.search(q, k, nprobe=nprobe)
    np.testing.assert_array_equal(i_p, i_j)
    np.testing.assert_allclose(s_p, s_j, atol=SIM_TOL, rtol=0)
    assert s_p.dtype == np.float32 and i_p.dtype == np.int64
    return i_p


# ------------------------------------------------------------- k-means

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", [65536, 100])
def test_kmeans_assign_matches_jax(dtype, chunk):
    jdt, tdt = DTYPES[dtype]
    pts = _clustered(1, n=600, d=24)
    cents = _unit(np.random.default_rng(2), 40, 24) * 3.0
    a_j, s_j = jk.kmeans_assign(jnp.asarray(pts).astype(jdt),
                                jnp.asarray(cents), chunk=chunk)
    a_p, s_p = pk.kmeans_assign(torch.from_numpy(pts).to(tdt),
                                torch.from_numpy(cents), chunk=chunk)
    assert a_p.dtype == torch.int32 and s_p.dtype == torch.float32
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), atol=SIM_TOL,
                               rtol=0)


@pytest.mark.parametrize("seed,cap_factor", [(0, 1.05), (3, 1.0), (5, 1.3)])
def test_balanced_assign_matches_jax_and_respects_cap(seed, cap_factor):
    pts = _skewed(seed)
    cents, _ = jk.kmeans_fit(jnp.asarray(pts), 16, iters=6)
    cap = int(np.ceil(1000 / 16 * cap_factor))
    want = jk.balanced_assign(jnp.asarray(pts), cents, cap, chunk=256)
    got = pk.balanced_assign(torch.from_numpy(pts),
                             torch.from_numpy(np.array(cents)), cap,
                             chunk=256)
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=16)
    assert counts.max() <= cap and counts.sum() == 1000 and (got >= 0).all()
    with pytest.raises(ValueError, match="cap"):
        pk.balanced_assign(torch.from_numpy(pts),
                           torch.from_numpy(np.array(cents)), 10)


LLOYD_CASES = {
    # name: (n, d, clusters, iters, seed, valid share or None)
    "plain": (512, 16, 8, 6, 0, None),
    "valid_mask": (512, 16, 8, 5, 1, 0.7),
    # 16 draws from 48 rows repeat a row: duplicate centroids leave a
    # cluster empty, which the loop reseeds from the worst-fitting rows.
    "empty_reseed": (48, 8, 16, 4, 3, None),
    "empty_reseed_masked": (64, 8, 16, 3, 4, 0.6),
    "no_iterations": (256, 16, 8, 0, 7, None),
}


@pytest.mark.parametrize("case", sorted(LLOYD_CASES))
def test_lloyd_from_jax_init_matches_jax(monkeypatch, case):
    n, d, c, iters, seed, share = LLOYD_CASES[case]
    rng = np.random.default_rng(seed)
    pts = _clustered(seed, n=n, d=d, centers=max(2, c // 2))
    valid = None if share is None else rng.random(n) < share
    init = _jax_init(n, c, seed, valid)
    if case.startswith("empty"):
        assert len(set(init.tolist())) < c
    if valid is not None:
        assert valid[init].all()
    jv = None if valid is None else jnp.asarray(valid)
    c_j, a_j = jk.kmeans_fit(jnp.asarray(pts), c, iters=iters, seed=seed,
                             valid=jv)
    _inject(monkeypatch, init)
    c_p, a_p = pk.kmeans_fit(torch.from_numpy(pts), c, iters=iters,
                             seed=seed, valid=None if valid is None
                             else torch.from_numpy(valid))
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), atol=CENT_TOL,
                               rtol=0)
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    if valid is not None:
        assert (a_p.numpy()[~valid] == 0).all()


def test_kmeans_init_is_seeded_and_device_free():
    pts = torch.from_numpy(_clustered(3, n=300, d=8))
    valid = torch.from_numpy(np.arange(300) % 3 != 0)
    a = pk._init_centroids(pts, 12, 5, valid)
    b = pk._init_centroids(pts, 12, 5, valid)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = {tuple(r) for r in pts[valid].tolist()}
    assert all(tuple(r) in rows for r in a.tolist())
    assert not torch.equal(a, pk._init_centroids(pts, 12, 6, valid))
    c, assign = pk.kmeans_fit(pts, 12, iters=4, seed=5)
    assert c.shape == (12, 8) and assign.shape == (300,)
    torch.testing.assert_close(c.norm(dim=1), torch.ones(12))


# ------------------------------------------------------------- IVFIndex

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("balanced", [False, True])
def test_search_from_jax_state_matches_jax(tmp_path, dtype, balanced):
    jdt, _ = DTYPES[dtype]
    docs = _clustered(11)
    q = _unit(np.random.default_rng(12), 8, 32)
    ref = JaxIVF(num_clusters=32, nprobe=4, kmeans_iters=6, tile=128)
    ref.build(docs, storage_dtype=jdt, balanced=balanced)
    # In memory, and through the JAX package's snapshot files (bfloat16
    # rows there are raw 2-byte records).
    jax_save_state(str(tmp_path), "ivf", ref.state_dict())
    for state in (ref.state_dict(), load_state(str(tmp_path), "ivf")):
        port = IVFIndex.from_state_dict(state, device="cpu")
        assert port._sorted_emb.dtype == DTYPES[dtype][1]
        for nprobe in (1, 4, 32):
            _same_search(port, ref, q, 10, nprobe)
        _same_search(port, ref, q, 10, None)


def test_full_probe_equals_exact(rng):
    """tests/test_index.py's oracle: probing every cluster is exact."""
    docs = _unit(rng, 2000, 64)
    ivf = IVFIndex(num_clusters=16, nprobe=16, tile=128, seed=0,
                   device="cpu")
    ivf.build(docs)
    q = _unit(rng, 4, 64)
    s, ids = ivf.search(q, k=10)
    sims = q @ docs.T
    oracle = np.argsort(-sims, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids, oracle)
    np.testing.assert_allclose(s, np.take_along_axis(sims, oracle, axis=1),
                               atol=SIM_TOL, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("balanced", [False, True])
def test_build_from_jax_init_matches_jax(monkeypatch, dtype, balanced):
    jdt, tdt = DTYPES[dtype]
    docs = _clustered(21, n=2048, d=32)
    ref = JaxIVF(num_clusters=32, nprobe=8, kmeans_iters=6, tile=128,
                 seed=3)
    ref.build(docs, storage_dtype=jdt, balanced=balanced)
    _inject(monkeypatch, _jax_init(2048, 32, 3))
    port = IVFIndex(num_clusters=32, nprobe=8, kmeans_iters=6, tile=128,
                    seed=3, device="cpu")
    port.build(docs, storage_dtype=tdt, balanced=balanced)
    emb64 = np.asarray(jnp.asarray(docs).astype(jdt).astype(jnp.float32),
                       np.float64)
    moved = _held_build(port, ref, emb64)
    assert moved == 0
    if balanced:
        assert np.asarray(port._counts).max() <= int(np.ceil(2048 / 32
                                                             * 1.15))
        assert port._window % 128 == 0
    else:
        assert port._window % 128 == 0 and port._window >= int(
            port._counts.max())
    q = _unit(np.random.default_rng(22), 6, 32)
    for nprobe in (1, 8, 32):
        _same_search(port, ref, q, 10, nprobe)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_state_crosses_both_ways(tmp_path, dtype):
    jdt, tdt = DTYPES[dtype]
    docs = _clustered(31, n=1024, d=16, centers=16)
    q = _unit(np.random.default_rng(32), 5, 16)
    port = IVFIndex(num_clusters=16, nprobe=4, kmeans_iters=5, tile=128,
                    device="cpu")
    port.build(docs, storage_dtype=tdt)
    # The port's state in the JAX package (16-bit rows as float32 numpy).
    save_state(str(tmp_path / "p"), "ivf", port.state_dict())
    ref = JaxIVF.from_state_dict(jax_load_state(str(tmp_path / "p"), "ivf"))
    for nprobe in (1, 4, 16):
        _same_search(port, ref, q, 7, nprobe)
    # ... and back into the port, in its storage dtype.
    again = IVFIndex.from_state_dict(load_state(str(tmp_path / "p"), "ivf"),
                                     device="cpu")
    assert again._sorted_emb.dtype == tdt
    torch.testing.assert_close(again._sorted_emb, port._sorted_emb,
                               rtol=0, atol=0)
    # The JAX package's state in the port.
    built = JaxIVF(num_clusters=16, nprobe=4, kmeans_iters=5, tile=128)
    built.build(docs, storage_dtype=jdt)
    jax_save_state(str(tmp_path / "j"), "ivf", built.state_dict())
    back = IVFIndex.from_state_dict(load_state(str(tmp_path / "j"), "ivf"),
                                    device="cpu")
    assert back._sorted_emb.dtype == tdt
    for nprobe in (1, 4, 16):
        _same_search(back, built, q, 7, nprobe)


def test_custom_ids_and_padding_match_jax():
    docs = _unit(np.random.default_rng(41), 600, 32)
    ext_ids = np.arange(600) * 7  # non-contiguous external ids
    ref = JaxIVF(num_clusters=8, nprobe=8, tile=128)
    ref.build(docs, ids=ext_ids)
    port = IVFIndex.from_state_dict(ref.state_dict(), device="cpu")
    _, ids = port.search(docs[42:43], k=1)
    assert ids[0, 0] == 42 * 7
    own = IVFIndex(num_clusters=8, nprobe=8, tile=128, device="cpu")
    own.build(docs, ids=ext_ids)
    assert own.search(docs[42:43], k=1)[1][0, 0] == 42 * 7
    # A corpus smaller than k: -inf / -1 padding, as the reference.
    small = _unit(np.random.default_rng(42), 6, 32)
    ref = JaxIVF(num_clusters=4, nprobe=4, tile=128)
    ref.build(small)
    port = IVFIndex.from_state_dict(ref.state_dict(), device="cpu")
    q = _unit(np.random.default_rng(43), 3, 32)
    ids = _same_search(port, ref, q, 10, None)
    s, _ = port.search(q, 10)
    assert (ids[:, 6:] == -1).all() and np.isneginf(s[:, 6:]).all()
    assert (np.sort(ids[:, :6], axis=1) == np.arange(6)).all()
    # One probed cluster can hold fewer rows than k: missing slots are -1.
    ids = _same_search(port, ref, q, 5, 1)
    assert ((ids == -1) == ~np.isfinite(port.search(q, 5, nprobe=1)[0])
            ).all()


def test_balanced_build_recall():
    """tests/test_index.py's balanced build: capped clusters, a window of
    the rounded cap, recall@10 >= 0.95 at nprobe 16."""
    rng = np.random.default_rng(51)
    centers = rng.standard_normal((32, 32)).astype(np.float32)
    docs = centers[rng.integers(0, 32, 4096)] + \
        0.2 * rng.standard_normal((4096, 32)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[rng.integers(0, 4096, 16)] + \
        0.05 * rng.standard_normal((16, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ivf = IVFIndex(num_clusters=32, nprobe=16, kmeans_iters=8, tile=256,
                   device="cpu")
    ivf.build(docs, balanced=True)
    assert int(ivf._counts.max()) <= int(np.ceil(4096 / 32 * 1.15))
    assert ivf._window <= 256
    _, ids = ivf.search(q, k=10)
    oracle = np.argsort(-(q @ docs.T), axis=1)[:, :10]
    recall = np.mean([len(set(ids[r]) & set(oracle[r])) / 10
                      for r in range(16)])
    assert recall >= 0.95, recall


def test_probe_respects_owned_clusters():
    """``owned`` masks the probe to a cluster subset (the sharded
    composition's use): only rows of owned clusters come back."""
    from optimized_rag_tpu.index.ivf import _ivf_search as jax_search
    from optimized_rag_tpu_torch.index.ivf import _ivf_search
    docs = _clustered(61, n=1024, d=16, centers=16)
    ref = JaxIVF(num_clusters=16, nprobe=16, tile=128)
    ref.build(docs)
    st = ref.state_dict()
    owned = np.arange(16) % 3 == 0
    q = _unit(np.random.default_rng(62), 4, 16)
    s_j, sl_j = jax_search(jnp.asarray(q), ref._centroids, ref._sorted_emb,
                           ref._starts, ref._counts, k=8, nprobe=4,
                           window=ref._window, owned=jnp.asarray(owned))
    port = IVFIndex.from_state_dict(st, device="cpu")
    s_p, sl_p = _ivf_search(torch.from_numpy(q), port._centroids,
                            port._sorted_emb, port._starts, port._counts,
                            k=8, nprobe=4, window=port._window,
                            owned=torch.from_numpy(owned))
    np.testing.assert_array_equal(sl_p.numpy(), np.asarray(sl_j))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), atol=SIM_TOL,
                               rtol=0)
    starts, counts = np.asarray(st["starts"]), np.asarray(st["counts"])
    cluster = np.searchsorted(starts + counts, sl_p.numpy(), side="right")
    assert owned[cluster].all()


def test_build_index_for_ivf_matches_jax():
    s = Settings()
    s.ivf.num_clusters, s.ivf.nprobe, s.ivf.kmeans_iters = 48, 6, 3
    got = policy.build_index_for("ivf", 64, s, tile=256, device="cpu")
    want = jax_policy.build_index_for("ivf", 64, s, tile=256)
    assert isinstance(got, IVFIndex) and got.device.type == "cpu"
    for key in ("num_clusters", "nprobe", "kmeans_iters", "tile", "seed"):
        assert getattr(got, key) == getattr(want, key), key
