"""Sharded retrieval of the PyTorch port against the JAX package's, on the
CPU: the JAX package on its 8 virtual CPU devices (tests/conftest.py), the
port on 8 logical CPU devices (one device named eight times). Each case of
``tests/test_parallel.py`` runs on both with the same numpy inputs: ids
equal, scores within SIM_TOL (float32 products in two summation orders).
The sharded IVF builds inject the JAX package's k-means init into the port
(``tests/test_torch_ivf.py``). Two gloo processes stand in for two hosts on
the ``dcn`` axis and must give the one-process answer.
"""

import importlib
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.parallel import mesh as jax_mesh
from optimized_rag_tpu.parallel import sharded_ivf as jax_ivf
from optimized_rag_tpu_torch.ops import kmeans as pk
from optimized_rag_tpu_torch.parallel import mesh, sharded_ivf
from optimized_rag_tpu_torch.parallel.sharded_topk import (
    ShardedDenseIndex, sharded_topk)

# The packages' ``parallel`` re-exports the function ``sharded_topk``
# under its module's name.
jax_topk = importlib.import_module("optimized_rag_tpu.parallel.sharded_topk")
port_topk = importlib.import_module(
    "optimized_rag_tpu_torch.parallel.sharded_topk")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8
SIM_TOL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _both_topk(q, docs, k, sizes, **kw):
    """sharded_topk of both packages over an 8-way data mesh: (scores, ids)
    of each, as numpy."""
    jm = jax_mesh.make_mesh(data=8)
    pm = mesh.make_mesh(data=8, devices=CPU8)
    impl = kw.pop("impl", "auto")
    js, ji = jax_topk.sharded_topk(
        jnp.asarray(q), jax_mesh.shard_corpus(jm, jnp.asarray(docs)), k,
        mesh=jm, sizes=jnp.asarray(sizes, jnp.int32),
        impl="pallas" if impl == "kernel" else impl, **kw)
    ps, pi = sharded_topk(torch.from_numpy(q),
                          mesh.shard_corpus(pm, docs), k, mesh=pm,
                          sizes=sizes, impl=impl, **kw)
    return (ps.numpy(), pi.numpy()), (np.asarray(js), np.asarray(ji))


def _same(port, ref):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], atol=SIM_TOL, rtol=0)


def _pair_index(dim, capacity_block, tile, dtype=(jnp.float32,
                                                   torch.float32)):
    jm = jax_mesh.make_mesh(data=8)
    ref = jax_topk.ShardedDenseIndex(dim=dim, mesh=jm, dtype=dtype[0],
                                     capacity_block=capacity_block, tile=tile)
    port = ShardedDenseIndex(dim=dim, mesh=mesh.make_mesh(data=8,
                                                          devices=CPU8),
                             dtype=dtype[1], capacity_block=capacity_block,
                             tile=tile)
    return port, ref


def _same_maps(port, ref):
    np.testing.assert_array_equal(port._sizes, ref._sizes)
    np.testing.assert_array_equal(port._rows_by_ext, ref._rows_by_ext)
    np.testing.assert_array_equal(port._row_to_ext, ref._row_to_ext)
    assert port.shard_capacity == ref.shard_capacity


# ------------------------------------------------------------------ mesh

def test_eight_logical_devices(monkeypatch):
    assert len(jax.devices()) == 8
    pm, jm = mesh.make_mesh(data=8, devices=CPU8), jax_mesh.make_mesh(data=8)
    assert pm.shape == dict(jm.shape) == {"data": 8, "model": 1}
    assert pm.axis_names == jm.axis_names
    assert mesh.make_mesh(model=2, devices=CPU8).shape == dict(
        jax_mesh.make_mesh(model=2).shape)
    with pytest.raises(ValueError, match="devices"):
        mesh.make_mesh(data=16, devices=CPU8)
    with pytest.raises(AssertionError):
        jax_mesh.make_mesh(data=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(data=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(data=2, devices=["cuda:0", "cuda:0"])


def test_shard_corpus_places_one_block_per_shard(rng):
    docs = _unit(rng, 8 * 16, 4)
    pm = mesh.make_mesh(data=4, model=2, devices=CPU8)
    blocks = mesh.shard_corpus(pm, docs)
    assert len(blocks) == 4
    for j, b in enumerate(blocks):
        np.testing.assert_array_equal(b.numpy(), docs[j * 32:(j + 1) * 32])
    assert len(mesh.shard_corpus(pm, docs, mesh.replicated_sharding(pm))) == 1
    with pytest.raises(ValueError, match="split"):
        mesh.shard_corpus(pm, docs[:30])


# ---------------------------------------------------------- sharded_topk

def test_sharded_topk_matches_oracle(rng):
    n, d, k = 8 * 512, 64, 10
    docs = _unit(rng, n, d)
    q = _unit(rng, 4, d)
    port, ref = _both_topk(q, docs, k, [n // 8] * 8)
    _same(port, ref)
    oracle = np.argsort(-(q @ docs.T), axis=1)[:, :k]
    np.testing.assert_array_equal(port[1], oracle)


def test_sharded_topk_respects_per_shard_sizes(rng):
    n, d, k = 8 * 256, 32, 5
    docs = _unit(rng, n, d)
    live = np.zeros(n, bool)
    per = n // 8
    for s in range(8):
        live[s * per: s * per + 100] = True
    q = _unit(rng, 2, d)
    port, ref = _both_topk(q, docs, k, np.full(8, 100, np.int32))
    _same(port, ref)
    assert live[port[1]].all()
    scores_masked = q @ docs.T
    scores_masked[:, ~live] = -np.inf
    np.testing.assert_array_equal(
        port[1], np.argsort(-scores_masked, axis=1)[:, :k])


@pytest.mark.parametrize("impl", ["auto", "chunked", "kernel"])
def test_sharded_topk_impls_agree(rng, impl):
    n, d, k = 8 * 1024, 32, 7
    docs = _unit(rng, n, d)
    q = _unit(rng, 2, d)
    port, ref = _both_topk(q, docs, k, [n // 8] * 8, impl=impl, tile=256,
                           chunk=256)
    _same(port, ref)
    np.testing.assert_array_equal(
        port[1], np.argsort(-(q @ docs.T), axis=1)[:, :k])


def test_sharded_topk_kernel_route_takes_the_verified_search(rng,
                                                             monkeypatch):
    """A shard of at least 8*k tiles runs topk_verified (tile_k 2), a
    smaller one tiled_topk: the reference's rule (sharded_topk.py:55-68)."""
    st = port_topk
    seen = []
    for name in ("topk_verified", "tiled_topk"):
        fn = getattr(st, name)
        monkeypatch.setattr(st, name, lambda *a, _f=fn, _n=name, **kw: (
            seen.append((_n, kw.get("tile_k"))), _f(*a, **kw))[1])
    docs = _unit(rng, 8 * 2048, 16)
    q = _unit(rng, 3, 16)
    for k, want in ((2, ("topk_verified", 2)), (3, ("tiled_topk", None))):
        seen.clear()
        port, ref = _both_topk(q, docs, k, [2048] * 8, impl="kernel",
                               tile=128)
        _same(port, ref)
        assert seen == [want] * 8


def test_sharded_topk_ties_go_to_the_lower_shard(rng):
    """Duplicate rows across shards: the JAX merge (lax.top_k over the
    gathered winners) gives a tie to the lower position, the lower shard."""
    d, k = 16, 6
    base = _unit(rng, 8, d)
    docs = np.tile(base, (8 * 4, 1))     # every row in every shard 4 times
    q = _unit(rng, 3, d)
    for impl in ("auto", "chunked", "kernel"):
        port, ref = _both_topk(q, docs, k, [32] * 8, impl=impl, tile=8,
                               chunk=16)
        _same(port, ref)
        assert (np.diff(port[1], axis=1) > 0).all()


# ------------------------------------------------------ ShardedDenseIndex

def test_sharded_dense_index_add_and_search(rng):
    port, ref = _pair_index(32, 8 * 256, 256)
    docs = _unit(rng, 300, 32)
    assert port.add(docs).tolist() == ref.add(docs).tolist() == list(
        range(300))
    _same_maps(port, ref)
    for impl in ("auto", "chunked", "kernel"):
        got = port.search(docs[17:19], k=3, impl=impl)
        _same(got, ref.search(docs[17:19], k=3,
                              impl="pallas" if impl == "kernel" else impl))
        assert got[1][0, 0] == 17 and got[0][0, 0] > 0.999
        assert got[0].dtype == np.float32 and got[1].dtype == np.int64


def test_sharded_dense_index_incremental_adds(rng):
    port, ref = _pair_index(16, 8 * 256, 256)
    a, b = _unit(rng, 100, 16), _unit(rng, 100, 16)
    for idx in (port, ref):
        idx.add(a)
    assert port.add(b)[0] == ref.add(b)[0] == 100
    _same_maps(port, ref)
    got = port.search(b[5:6], k=1)
    _same(got, ref.search(b[5:6], k=1))
    assert got[1][0, 0] == 105


def test_sharded_dense_index_grows_capacity(rng):
    port, ref = _pair_index(16, 8 * 256, 256)
    cap0 = port.shard_capacity
    docs = _unit(rng, 8 * 256 + 50, 16)   # overflow initial capacity
    port.add(docs)
    ref.add(docs)
    assert port.shard_capacity > cap0 and port.size == len(docs)
    _same_maps(port, ref)
    assert all(e.shape[0] == port.shard_capacity for e in port._emb)
    got = port.search(docs[2090:2094], k=4)
    _same(got, ref.search(docs[2090:2094], k=4))
    assert got[1][0, 0] == 2090


def test_sharded_index_bulk_add_and_id_maps(rng):
    """Water-filled placement stays balanced across grows, and the
    persistent row<->ext maps equal the JAX package's."""
    port, ref = _pair_index(16, 8 * 256, 256)
    all_ids = []
    for n in (100, 3000, 7):
        x = _unit(rng, n, 16)
        all_ids.append(port.add(x))
        np.testing.assert_array_equal(all_ids[-1], ref.add(x))
    ids = np.concatenate(all_ids)
    assert (ids == np.arange(3107)).all()
    assert port._sizes.max() - port._sizes.min() <= 1
    _same_maps(port, ref)
    rows = port._rows_by_ext
    assert (port._row_to_ext[rows] == np.arange(3107)).all()
    assert (port._row_to_ext >= 0).sum() == 3107
    q = _unit(rng, 5, 16)
    _same(port.search(q, 9), ref.search(q, 9))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bulk_build_matches_jax(rng, dtype):
    """bulk_build from numpy (and from a tensor: the same rows) lays the
    rows out as the JAX package's does; its search equals the JAX one."""
    dt = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    docs = rng.standard_normal((8 * 256 + 77, 16)).astype(np.float32)
    port, ref = _pair_index(16, 8 * 256, 256, dt)
    kept = docs.copy()
    # The JAX package normalises a float32 caller's rows in place.
    np.testing.assert_array_equal(port.bulk_build(docs, batch=100),
                                  ref.bulk_build(docs.copy(), batch=100))
    np.testing.assert_array_equal(docs, kept)
    _same_maps(port, ref)
    stored = np.concatenate([e.float().numpy() for e in port._emb])
    np.testing.assert_array_equal(
        stored, np.asarray(ref._emb.astype(jnp.float32)))
    from_tensor = _pair_index(16, 8 * 256, 256, dt)[0]
    from_tensor.bulk_build(torch.from_numpy(docs), batch=100)
    for a, b in zip(from_tensor._emb, port._emb):
        torch.testing.assert_close(a.float(), b.float(), atol=1e-7,
                                   rtol=2.0 ** -8)
    q = _unit(rng, 6, 16)
    for impl in ("auto", "kernel"):
        _same(port.search(q, 10, impl=impl),
              ref.search(q, 10, impl="pallas" if impl == "kernel" else impl))
    with pytest.raises(ValueError, match="empty"):
        port.bulk_build(docs)


def test_sharded_index_search_host_work_is_o_k(rng):
    """Search host-side id mapping does not scale with N: ~1M rows through
    several capacity grows, exact self-hits, and the mapped search far
    below an O(N) host pass (the bound of tests/test_parallel.py)."""
    idx = ShardedDenseIndex(dim=8, mesh=mesh.make_mesh(data=8,
                                                       devices=CPU8),
                            capacity_block=8 * 1024, tile=256)
    n = 1_050_000
    docs = _unit(rng, n, 8)
    t0 = time.time()
    ids = idx.add(docs)
    add_s = time.time() - t0
    t0 = time.time()
    _ = {int(i): int(i) for i in range(n)}
    host_pass_s = max(time.time() - t0, 0.05)
    assert add_s < 120 * host_pass_s + 30, (add_s, host_pass_s)
    assert idx.size == n and len(ids) == n
    probe_ext = np.array([0, 123_456, 999_999])
    probe_rows = idx._rows_by_ext[probe_ext]
    cap = idx.shard_capacity
    q = np.stack([idx._emb[r // cap][r % cap].numpy() for r in probe_rows])
    idx.search(q, k=5)
    search_s = float("inf")
    for _ in range(3):
        t0 = time.time()
        scores, got = idx.search(q, k=5)
        search_s = min(search_s, time.time() - t0)
    assert (got[:, 0] == probe_ext).all(), got[:, 0]
    assert search_s < max(4 * host_pass_s, 1.0), (search_s, host_pass_s)


def test_sharded_dense_missing_slots_use_inf_convention(rng):
    port, ref = _pair_index(16, 8 * 256, 256)
    docs = _unit(rng, 10, 16)          # 10 rows over 8 shards, k=10
    port.add(docs)
    ref.add(docs)
    scores, ids = port.search(docs[:2], k=10)
    _same((scores, ids), ref.search(docs[:2], k=10))
    live = ids >= 0
    assert np.isfinite(scores[live]).all()
    assert (scores[~live] == -np.inf).all(), scores[~live]
    assert ids[0, 0] == 0 and ids[1, 0] == 1
    s20, i20 = port.search(docs[:2], k=20)       # k past the corpus pads
    _same((s20, i20), ref.search(docs[:2], k=20))
    assert (i20[:, 10:] == -1).all()
    empty = _pair_index(16, 8 * 256, 256)[0]
    s0, i0 = empty.search(docs[:3], k=4)
    assert s0.shape == (3, 4) and (i0 == -1).all() and (s0 == -np.inf).all()


# ---------------------------------------------------------- sharded IVF

def _jax_init(n, c, seed):
    return np.asarray(jax.random.choice(
        jax.random.PRNGKey(seed), n, (c,),
        p=jnp.ones((n,), jnp.float32) / n))


def _inject(monkeypatch, idx):
    monkeypatch.setattr(pk, "_init_centroids",
                        lambda pts, c, seed, valid: pts[torch.as_tensor(
                            np.asarray(idx, np.int64))])


def test_partition_clusters_balances():
    counts = np.array([100, 90, 10, 10, 10, 10, 50, 40, 30, 20])
    shard_of = sharded_ivf.partition_clusters(counts, 4)
    np.testing.assert_array_equal(
        shard_of, jax_ivf.partition_clusters(counts, 4))
    load = np.zeros(4, np.int64)
    np.add.at(load, shard_of, counts)
    assert load.max() - load.min() <= 100


def _pair_ivf(monkeypatch, docs, build_kw=(), **kw):
    jm = jax_mesh.make_mesh(data=8)
    ref = jax_ivf.ShardedIVFIndex(jm, **kw)
    ref.build(docs, **dict(build_kw))
    c = min(kw["num_clusters"], max(8, len(docs) // 4))
    _inject(monkeypatch, _jax_init(len(docs), c, kw.get("seed", 0)))
    port = sharded_ivf.ShardedIVFIndex(
        mesh.make_mesh(data=8, devices=CPU8), **kw)
    port.build(docs, **dict(build_kw))
    assert port._npad == ref._npad and port._window == ref._window
    np.testing.assert_array_equal(port._row_to_ext, ref._row_to_ext)
    return port, ref


def test_sharded_ivf_recall_vs_oracle(rng, monkeypatch):
    n, d, k = 8192, 32, 10
    centers = _unit(rng, 64, d)
    docs = centers[rng.integers(0, 64, n)] + \
        0.25 * rng.standard_normal((n, d)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    q = docs[rng.integers(0, n, 16)] + \
        0.05 * rng.standard_normal((16, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    port, ref = _pair_ivf(monkeypatch, docs, num_clusters=64, nprobe=16,
                          kmeans_iters=8, tile=256)
    scores, ids = port.search(q, k)
    _same((scores, ids), ref.search(q, k))
    for nprobe in (1, 4, 64):
        _same(port.search(q, k, nprobe=nprobe),
              ref.search(q, k, nprobe=nprobe))
    oracle = np.argsort(-(q @ docs.T), axis=1)[:, :k]
    recall = np.mean([len(set(ids[r]) & set(oracle[r])) / k
                      for r in range(len(q))])
    assert recall >= 0.9, recall
    assert abs(q[0] @ docs[ids[0, 0]] - scores[0, 0]) < 1e-3


@pytest.mark.parametrize("balanced", [False, True])
def test_sharded_ivf_bf16_and_balanced_match_jax(rng, monkeypatch, balanced):
    docs = _unit(rng, 2048, 16)
    jm = jax_mesh.make_mesh(data=8)
    ref = jax_ivf.ShardedIVFIndex(jm, num_clusters=32, nprobe=8,
                                  kmeans_iters=4, tile=128)
    ref.build(docs, storage_dtype=jnp.bfloat16, balanced=balanced)
    _inject(monkeypatch, _jax_init(2048, 32, 0))
    port = sharded_ivf.ShardedIVFIndex(mesh.make_mesh(data=8, devices=CPU8),
                                       num_clusters=32, nprobe=8,
                                       kmeans_iters=4, tile=128)
    port.build(docs, storage_dtype=torch.bfloat16, balanced=balanced)
    assert (port._npad, port._window) == (ref._npad, ref._window)
    np.testing.assert_array_equal(port._row_to_ext, ref._row_to_ext)
    q = _unit(rng, 5, 16)
    for nprobe in (2, 8, 32):
        _same(port.search(q, 7, nprobe=nprobe),
              ref.search(q, 7, nprobe=nprobe))


def test_sharded_ivf_external_ids_and_small_k(rng, monkeypatch):
    docs = _unit(rng, 1024, 16)
    ext = np.arange(1024, dtype=np.int64) + 5000
    jm = jax_mesh.make_mesh(data=8)
    ref = jax_ivf.ShardedIVFIndex(jm, num_clusters=16, nprobe=16, tile=256)
    ref.build(docs, ids=ext)
    _inject(monkeypatch, _jax_init(1024, 16, 0))
    port = sharded_ivf.ShardedIVFIndex(mesh.make_mesh(data=8, devices=CPU8),
                                       num_clusters=16, nprobe=16, tile=256)
    port.build(docs, ids=ext)
    scores, ids = port.search(docs[:4], k=3)
    _same((scores, ids), ref.search(docs[:4], k=3))
    assert (ids[:, 0] == ext[:4]).all()
    s2, ids2 = port.search(docs[:2], k=2000)
    _same((s2, ids2), ref.search(docs[:2], k=2000))
    assert (ids2 >= -1).all() and ids2.shape == (2, 2000)
    with pytest.raises(RuntimeError, match="build"):
        sharded_ivf.ShardedIVFIndex(mesh.make_mesh(data=8, devices=CPU8)
                                    ).search(docs[:1], 1)


# --------------------------------------------------- multi-host (dcn)

def test_multihost_mesh_single_process_shape():
    pm = mesh.make_multihost_mesh(model=1, devices=CPU8)
    jm = jax_mesh.make_multihost_mesh(model=1)
    assert pm.axis_names == jm.axis_names == ("dcn", "data", "model")
    assert pm.shape == dict(jm.shape)
    assert pm.shape["dcn"] == 1 and pm.shape["data"] == 8


def test_sharded_topk_over_composite_dcn_axis(rng):
    """The same sharded top-k over the (dcn, data) composite axis of a
    multi-host-shaped mesh, (1, 4, 2) on 8 logical devices."""
    pm = mesh.make_multihost_mesh(model=2, devices=CPU8)
    jm = jax_mesh.make_multihost_mesh(model=2)
    assert pm.shape == dict(jm.shape)
    ndev = pm.shape["dcn"] * pm.shape["data"]
    n, d, k = ndev * 512, 64, 10
    docs = _unit(rng, n, d)
    q = _unit(rng, 8, d)
    js, ji = jax_topk.sharded_topk(
        jnp.asarray(q), jax.device_put(jnp.asarray(docs),
                                       jax_mesh.dcn_corpus_sharding(jm)),
        k, mesh=jm, sizes=jnp.full((ndev,), n // ndev, jnp.int32),
        axis=("dcn", "data"))
    ps, pi = sharded_topk(
        torch.from_numpy(q),
        mesh.shard_corpus(pm, docs, mesh.dcn_corpus_sharding(pm)), k,
        mesh=pm, sizes=[n // ndev] * ndev, axis=("dcn", "data"))
    _same((ps.numpy(), pi.numpy()), (np.asarray(js), np.asarray(ji)))
    np.testing.assert_array_equal(pi.numpy(),
                                  np.argsort(-(q @ docs.T), axis=1)[:, :k])


_GLOO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from optimized_rag_tpu_torch.parallel import mesh
from optimized_rag_tpu_torch.parallel.sharded_topk import sharded_topk

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
try:
    z = np.load(path)
    m = mesh.make_multihost_mesh(devices=[torch.device("cpu")] * 4)
    assert m.shape == {"dcn": 2, "data": 4, "model": 1}, m.shape
    blocks = mesh.shard_corpus(m, z["docs"], mesh.dcn_corpus_sharding(m))
    out = {}
    for impl in ("auto", "chunked", "kernel"):
        s, i = sharded_topk(torch.from_numpy(z["q"]), blocks, int(z["k"]),
                            mesh=m, sizes=z["sizes"], axis=("dcn", "data"),
                            impl=impl, tile=64, chunk=64)
        out[impl + "_s"], out[impl + "_i"] = s.numpy(), i.numpy()
    np.savez(path.replace(".npz", f"_rank{rank}.npz"), **out)
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one_process(rng, tmp_path):
    """Two processes, 4 logical devices each, on the dcn axis: every rank
    gets the answer of one process over the same 8 shards (rows and
    per-shard sizes alike)."""
    n, d, k = 8 * 512, 32, 9
    docs = _unit(rng, n, d)
    docs[1000:1040] = docs[3000:3040]          # ties across hosts
    q = np.concatenate([_unit(rng, 5, d), docs[3000:3001]])
    sizes = np.array([512, 500, 512, 3, 512, 512, 480, 512], np.int32)
    path = str(tmp_path / "in.npz")
    np.savez(path, docs=docs, q=q, sizes=sizes, k=k)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), str(port), path],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    one = mesh.make_multihost_mesh(devices=CPU8)
    blocks = mesh.shard_corpus(one, docs, mesh.dcn_corpus_sharding(one))
    for impl in ("auto", "chunked", "kernel"):
        s, i = sharded_topk(torch.from_numpy(q), blocks, k, mesh=one,
                            sizes=sizes, axis=("dcn", "data"), impl=impl,
                            tile=64, chunk=64)
        for r in range(2):
            got = np.load(str(tmp_path / f"in_rank{r}.npz"))
            np.testing.assert_array_equal(got[impl + "_i"], i.numpy())
            np.testing.assert_array_equal(got[impl + "_s"], s.numpy())
