"""The port's pretraining (``models/pretrain.py``) against the JAX
package's, on the CPU: the samplers give the same batches from the same
seed; ``train_biencoder`` cut at a snapshot and resumed follows JAX's
resumed run (float32, 1e-5; attention-key biases apart,
``tests/train_parity.py``); and checkpoints cross packages in both
directions: a port-written checkpoint has the JAX package's keys, shapes,
dtypes and config JSON, the JAX ``load_pretrained`` reads it, and the JAX
``EmbeddingService`` gives the port's vectors within 1e-6 (float32 and
float16 storage).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import encoder as je
from optimized_rag_tpu.models import loader as j_loader
from optimized_rag_tpu.models import pretrain as jp
from optimized_rag_tpu.models import training as jt
from optimized_rag_tpu.parallel.mesh import make_mesh as jax_make_mesh
from optimized_rag_tpu_torch.models import encoder as pe
from optimized_rag_tpu_torch.models import pretrain as pp
from optimized_rag_tpu_torch.models import training as pt
from optimized_rag_tpu_torch.parallel.mesh import make_mesh

import train_parity as tp

torch.set_num_threads(2)

CPU_MESH = make_mesh(data=1, devices=["cpu"])


def _texts(n=60):
    from optimized_rag_tpu_torch.eval.synthetic import make_dataset
    return make_dataset(num_docs=n, num_topics=6, num_queries=1,
                        seed=3).texts


def test_default_corpus_and_ict_sampler_equal_jax():
    assert pp.default_corpus(["x y z"]) == jp.default_corpus(["x y z"])
    texts = _texts() + ["one", ""]
    j, p = jp.ICTSampler(texts), pp.ICTSampler(texts)
    np.testing.assert_array_equal(p.usable, j.usable)
    j_rng, p_rng = np.random.default_rng(9), np.random.default_rng(9)
    for n in (8, 3, 16):
        a, b = j.sample(j_rng, n), p.sample(p_rng, n)
        assert a[0] == b[0] and a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
    assert pp.ict_pairs(texts, np.random.default_rng(2), 5)[0] == \
        jp.ict_pairs(texts, np.random.default_rng(2), 5)[0]
    with pytest.raises(ValueError):
        pp.ICTSampler(["a", "b"])


class _Recorder:
    """A trainer that records the rows it is given."""
    rows = []

    def __init__(self, *a, **kw):
        self.params = {}

    def train_step(self, ids):
        type(self).rows.append(np.array(ids))
        return 0.0


def test_train_decoder_windows_equal_jax(monkeypatch):
    texts = ["Bytes, ünïcode and a longer line of text. " * 3, "short",
             "x" * 50]
    _, cfg = tp.configs("decoder", "float32")
    got, want = [], []
    monkeypatch.setattr(pt, "DecoderTrainer", type(
        "P", (_Recorder,), {"rows": got}))
    monkeypatch.setattr(jt, "DecoderTrainer", type(
        "J", (_Recorder,), {"rows": want}))
    pp.train_decoder(texts, cfg, CPU_MESH, steps=3, batch=4)
    jp.train_decoder(texts, cfg, None, steps=3, batch=4)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32 and a.shape == (4, cfg.max_seq_len)


def _interrupt_at(step):
    """A query transform that stops the run at ``step``, as an outage
    would."""
    calls = []

    def transform(queries):
        calls.append(1)
        if len(calls) > step:
            raise RuntimeError("outage")
        return queries
    return transform


def test_train_biencoder_cut_at_snapshot_and_resumed_matches_jax(
        tmp_path, monkeypatch):
    """Five steps with a callable learning rate, a snapshot every 2; the
    run stops at step 3, and a relaunch resumes after the snapshot's step
    2 (the sampler replayed, the schedule shifted) in both packages, the
    port from the JAX trainer's initial weights."""
    jc, pc = tp.configs("encoder", "float32")
    init = tp.flat(jt.BiEncoderTrainer(jc, jax_make_mesh(data=1, model=1))
                   .params)

    class FromJaxInit(pt.BiEncoderTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.params = tp.port_params(init, "encoder", pc)
    monkeypatch.setattr(pt, "BiEncoderTrainer", FromJaxInit)
    sched = lambda count: 1e-4 * (1.0 + count)  # noqa: E731
    texts = _texts()
    kw = dict(steps=5, batch=8, learning_rate=sched, max_len=16,
              snapshot_every=2)
    runs = {}
    for pkg, mod, cfg, mesh in (("jax", jp, jc, jax_make_mesh(data=1,
                                                               model=1)),
                                ("port", pp, pc, CPU_MESH)):
        snap = str(tmp_path / pkg)
        logs = []
        with pytest.raises(RuntimeError, match="outage"):
            mod.train_biencoder(texts, cfg, mesh, snapshot_dir=snap,
                                query_transform=_interrupt_at(3), **kw)
        with open(os.path.join(snap, "biencoder.step.txt")) as f:
            assert f.read() == "2"
        params, loss = mod.train_biencoder(texts, cfg, mesh,
                                           snapshot_dir=snap,
                                           log=logs.append, **kw)
        assert not os.path.exists(os.path.join(snap, "biencoder.step.txt"))
        runs[pkg] = (params, loss, logs)
    assert runs["port"][2][0] == runs["jax"][2][0].replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1],
                               rtol=tp.F32_LOSS_RTOL)
    tp.hold_weights(tp.flat(runs["jax"][0]),
                    tp.port_flat(runs["port"][0], "encoder", pc),
                    tp.F32_WEIGHT_ATOL, pc.hidden_dim, 6e-4, 5)


def _npz(path, name):
    with np.load(os.path.join(path, f"{name}.params.npz")) as z:
        return {k: z[k] for k in z.files}


def _config_text(path, name):
    with open(os.path.join(path, f"{name}.config.json")) as f:
        return f.read()


@pytest.mark.parametrize("store", [None, np.float16])
def test_port_checkpoint_reads_in_jax(tmp_path, rng, store):
    """save_pretrained from a trained port bi-encoder: the JAX layout
    (keys, shapes, dtypes, config JSON text equal to the JAX package's own
    save of the same weights); the JAX EmbeddingService over the JAX
    load_pretrained gives the port's vectors within 1e-6."""
    jc, pc = tp.configs("encoder", "float32")
    trainer = pt.BiEncoderTrainer(pc, CPU_MESH, learning_rate=1e-3)
    trainer.train_step(*tp.encoder_batch(rng))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    pp.save_pretrained(port_dir, "biencoder", trainer.params, pc,
                       store_dtype=store)
    j_params = j_loader._unflatten(tp.port_flat(trainer.params, "encoder",
                                                pc))
    os.makedirs(jax_dir)
    jp.save_pretrained(jax_dir, "biencoder", j_params, jc,
                       store_dtype=store)
    got, want = _npz(port_dir, "biencoder"), _npz(jax_dir, "biencoder")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    assert _config_text(port_dir, "biencoder") == _config_text(
        jax_dir, "biencoder")
    assert json.loads(_config_text(port_dir, "biencoder"))["dtype"] == \
        "float32"
    cfg, params = jp.load_pretrained(port_dir, "biencoder")
    texts = _texts(12)
    j_vecs = je.EmbeddingService(cfg, params=params, max_len=16).encode(
        texts)
    p_cfg, state = pp.load_pretrained(port_dir, "biencoder")
    p_vecs = pe.EmbeddingService(p_cfg, params=state, max_len=16,
                                 device="cpu").encode(texts)
    np.testing.assert_allclose(p_vecs, j_vecs, atol=1e-6)
    if store is None:   # the trainer's own forward, unrounded
        ids, mask = pe.HashTokenizer(pc.vocab_size, 16).encode_batch(
            texts, 16)
        with torch.no_grad():
            own = trainer.model(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(p_vecs, own, atol=1e-6)


@pytest.mark.parametrize("family", ["encoder", "decoder", "grounded"])
def test_checkpoints_cross_packages_both_ways(tmp_path, family):
    """A JAX-saved checkpoint of each family loads into the port
    (float32 training form and serving form), and the port writes it back
    byte for byte in values, with the JAX package's config JSON."""
    jc, pc = tp.configs(family, "bfloat16")
    if family == "encoder":
        params = je.CrossEncoder(jc).init(
            jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
            jnp.ones((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
        name = "crossencoder"
    elif family == "decoder":
        params = jt.DecoderTrainer(jc, jax_make_mesh(data=1, model=1)).params
        name = "decoder"
    else:
        from optimized_rag_tpu.models.grounded import GroundedTrainer
        params = GroundedTrainer(jc, jax_make_mesh(data=1, model=1),
                                 prompt_len=tp.PROMPT,
                                 target_len=tp.TARGET).params
        name = "grounded"
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jax_dir)
    jp.save_pretrained(jax_dir, name, params, jc)
    cfg, state = pp.load_pretrained(jax_dir, name, param_dtype=torch.float32)
    assert cfg == pc and all(v.dtype == torch.float32 for v in state.values())
    _, serving = pp.load_pretrained(jax_dir, name)
    assert {v.dtype for v in serving.values()} == {torch.float32,
                                                   torch.bfloat16}
    pp.save_pretrained(port_dir, name, state, cfg)
    got, want = _npz(port_dir, name), _npz(jax_dir, name)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert _config_text(port_dir, name) == _config_text(jax_dir, name)


def test_pretrain_all_with_learned_vocab_writes_the_jax_layout(tmp_path):
    """pretrain_all trains and persists the three families and the learned
    vocabulary (the JAX package's file), each checkpoint read by the JAX
    package's load_pretrained with its config."""
    import dataclasses
    # train_biencoder's default max_len of 64 needs 64 positions.
    pc = dataclasses.replace(tp.configs("encoder", "float32")[1],
                             max_seq_len=64)
    _, dc = tp.configs("decoder", "float32")
    texts = _texts(40)
    out = pp.pretrain_all(str(tmp_path / "port"), texts, encoder_cfg=pc,
                          cross_cfg=pc, decoder_cfg=dc, mesh=CPU_MESH,
                          steps=2, batch=8, learned_vocab=True, log=None,
                          store_dtype=np.float16)
    assert set(out) == {"vocab_words", "biencoder_loss", "crossencoder_loss",
                        "decoder_loss"}
    assert all(np.isfinite(v) for v in out.values())
    from optimized_rag_tpu.models.tokenizer import VocabTokenizer
    want = VocabTokenizer.train(texts, pc.vocab_size)
    with open(tmp_path / "port" / "tokenizer.vocab.txt") as f:
        assert f.read().split("\n")[:len(want.words)] == want.words
    for name in ("biencoder", "crossencoder", "decoder"):
        cfg, _ = jp.load_pretrained(str(tmp_path / "port"), name)
        assert cfg.hidden_dim == 32 and cfg.dtype == jnp.float32
    assert pp.default_mesh("cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pp.default_mesh()
