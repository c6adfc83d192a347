"""The port's training-state checkpointer and parameter persistence, on
the CPU.

``TrainCheckpointer`` keeps the JAX package's directory layout
(``step_%08d``, ``latest_step``) in the port's own format; a run saved,
restored into fresh trainers and continued equals the uninterrupted run
bit for bit. ``save_params`` / ``load_params`` write and read the flattened
npz that the JAX package's functions read and write. ``import_hf_bert``
maps a random-init ``transformers`` BERT onto the port's trunk exactly as
the JAX package's mapping does through ``flax_to_torch`` (skipped where
``transformers`` is absent).
"""

import os

import numpy as np
import pytest
import torch

from optimized_rag_tpu.models import loader as j_loader
from optimized_rag_tpu_torch.models import convert
from optimized_rag_tpu_torch.models import encoder as pe
from optimized_rag_tpu_torch.models import loader as p_loader
from optimized_rag_tpu_torch.models.grounded import GroundedTrainer
from optimized_rag_tpu_torch.models.training import BiEncoderTrainer
from optimized_rag_tpu_torch.parallel.mesh import make_mesh
from optimized_rag_tpu_torch.store.checkpoint import TrainCheckpointer

import train_parity as tp

torch.set_num_threads(2)

MESH = make_mesh(data=1, devices=["cpu"])


def test_checkpointer_round_trip_and_layout(tmp_path):
    ck = TrainCheckpointer(str(tmp_path / "ckpt"))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt_state": {"count": 3, "mu": {"w": torch.ones(2, 3)},
                           "nu": {"w": torch.zeros(2, 3)}},
             "step": 3, "lrs": [1e-4, 2e-4]}
    for step in (3, 12, 7):
        path = ck.save(step, state)
        assert os.path.basename(path) == f"step_{step:08d}"
    assert ck.latest_step() == 12
    assert sorted(os.listdir(ck.directory)) == [
        "step_00000003", "step_00000007", "step_00000012"]
    got = ck.restore()
    assert got["step"] == 3 and got["opt_state"]["count"] == 3
    assert got["lrs"] == [1e-4, 2e-4]
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64)}}
    assert ck.restore(7, like=like)["params"]["w"].dtype == torch.float64
    ck.save(7, {"step": 8})                   # a step saved again replaces
    assert ck.restore(7) == {"step": 8}


@pytest.mark.parametrize("which", ["biencoder", "grounded"])
def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(tmp_path,
                                                              which):
    """Two steps, a save of params, optimizer state and step, a restore
    into a fresh trainer, two more steps: the uninterrupted four steps'
    losses and weights exactly (AdamW's count carries the schedule)."""
    sched = lambda count: 1e-3 / (1.0 + count)  # noqa: E731
    rng = np.random.default_rng(4)
    if which == "biencoder":
        _, cfg = tp.configs("encoder", "float32")
        make = lambda: BiEncoderTrainer(cfg, MESH, learning_rate=sched,  # noqa
                                        seed=1)
        batches = [tp.encoder_batch(rng) for _ in range(4)]
    else:
        _, cfg = tp.configs("grounded", "float32")
        make = lambda: GroundedTrainer(cfg, MESH, prompt_len=tp.PROMPT,  # noqa
                                       target_len=tp.TARGET,
                                       learning_rate=sched, seed=1)
        batches = [tp.grounded_batch(rng) for _ in range(4)]
    whole = make()
    want = [whole.train_step(*b) for b in batches]
    first = make()
    got = [first.train_step(*b) for b in batches[:2]]
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(2, {"params": first.params, "opt_state": first.opt_state,
                "step": 2})
    del first
    second = make()
    state = ck.restore()
    second.params, second.opt_state = state["params"], state["opt_state"]
    got += [second.train_step(*b) for b in batches[state["step"]:]]
    assert got == want
    a, b = whole.params, second.params
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert second.opt_state["count"] == 4


def test_save_and_load_params_cross_packages(tmp_path):
    _, cfg = tp.configs("encoder", "bfloat16")
    model = pe.training_module(lambda: pe.BiEncoder(cfg, torch.float32),
                               "cpu", 2)
    flat = convert.torch_to_flax(model.state_dict(), cfg)
    p_loader.save_params(str(tmp_path / "port"), "enc", flat)
    nested = p_loader.load_params(str(tmp_path / "port"), "enc")
    assert set(nested) == {"params"} and "trunk" in nested["params"]
    back = j_loader.load_params(str(tmp_path / "port"), "enc")
    assert j_loader._flatten(back).keys() == flat.keys()
    for k, v in j_loader._flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k])
    j_loader.save_params(str(tmp_path / "jax"), "enc", back)
    again = p_loader._flatten(p_loader.load_params(str(tmp_path / "jax"),
                                                   "enc"))
    assert again.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k])
    state = convert.flax_to_torch(again, cfg, param_dtype=torch.float32)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k


def test_import_hf_bert_matches_jax():
    transformers = pytest.importorskip("transformers")
    hf = transformers.BertModel(transformers.BertConfig(
        vocab_size=512, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=16))          # random init, no download
    sd = hf.state_dict()
    got = p_loader.import_hf_bert(sd, num_layers=2, num_heads=4,
                                  hidden_dim=32)
    jax_trunk = j_loader.import_hf_bert(sd, num_layers=2, num_heads=4,
                                        hidden_dim=32)
    _, cfg = tp.configs("encoder", "float32")
    want = convert.flax_to_torch(j_loader._flatten({"params": jax_trunk}),
                                 cfg, param_dtype=torch.float32)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_array_equal(
        got["trunk.emb.tok.weight"].numpy(),
        sd["embeddings.word_embeddings.weight"].numpy())
    model = pe.BiEncoder(cfg, torch.float32)
    missing = model.load_state_dict(got, strict=False).missing_keys
    assert missing == ["proj.weight", "proj.bias"]
    ids = torch.ones(1, 8, dtype=torch.long)
    assert torch.isfinite(model(ids, torch.ones(1, 8))).all()
    renamed = p_loader.import_hf_bert(sd, 2, 4, 32, trunk_key="backbone")
    assert sorted(renamed) == sorted("backbone" + k[5:] for k in got)
