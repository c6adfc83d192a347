"""The PyTorch port's CLI against the JAX package's, on the CPU.

Every case of ``tests/test_cli.py`` runs on both CLIs, the port's with
``--device cpu``, each over its own package's hermetic agent (the
``fast_agent_factory`` of ``tests/test_cli.py``: ``FakeEmbedder(dim=32)``,
``FakeCrossEncoder``, the same restart through ``load_indexes``), and the
two outputs are held line for line once timings and the data directory
are masked. Then the subcommands that test file leaves out: ``env-example``
(equal but for the line naming the package), ``hitl list / approve /
reject``, ``train`` on the CPU (the JAX CLI's lines, checkpoints the
agent finds), ``--local-lm`` (the same provider from the same
checkpoint), and ``python -m optimized_rag_tpu_torch`` in a subprocess that
loads no JAX.
"""

import os
import re
import subprocess
import sys
import time

import pytest
import torch

import optimized_rag_tpu.cli as jax_cli
import optimized_rag_tpu.native as jax_native
from optimized_rag_tpu.agent.agent import RAGAgent as JaxAgent
from optimized_rag_tpu.agent.llm import DeterministicLLM as JaxLLM
from optimized_rag_tpu.store.db import MetadataStore as JaxStore
from optimized_rag_tpu_torch import cli, native
from optimized_rag_tpu_torch.agent.agent import RAGAgent
from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.store.db import MetadataStore

from fakes import FakeCrossEncoder, FakeEmbedder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_790_000_000.0
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def hermetic(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_attempted", True)
    for name in ("term_counts", "model_tokenize", "vocab_tokenize"):
        monkeypatch.setattr(native, name, lambda *args: None)


@pytest.fixture
def both(tmp_path, monkeypatch):
    """A runner of one command line on both CLIs: each package's
    ``build_agent`` replaced by tests/test_cli.py's hermetic factory over
    its own data directory. Returns {"jax": (rc, out), "port": (rc, out)},
    timings and data directories masked."""

    def factory_for(pkg):
        jax = pkg == "jax"
        data = str(tmp_path / pkg / "data")

        def factory(settings, offline=True, **kw):
            settings.data_dir = data
            store = (JaxStore if jax else MetadataStore)(
                os.path.join(data, "metadata.db"))
            agent = (JaxAgent if jax else RAGAgent)(
                settings, llm=(JaxLLM if jax else DeterministicLLM)(),
                embed_service=FakeEmbedder(dim=32), store=store,
                cross_encoder=FakeCrossEncoder(),
                **({} if jax else {"device": kw.get("device", "cuda")}))
            agent.load_indexes()   # mirror cli.build_agent restart behavior
            return agent
        return data, factory

    def run(argv, capsys, inputs=None):
        out = {}
        for pkg, mod in (("jax", jax_cli), ("port", cli)):
            data, factory = factory_for(pkg)
            monkeypatch.setattr(mod, "build_agent", factory)
            monkeypatch.setenv("ORAG_DATA_DIR", data)
            if inputs is not None:
                feed = iter(inputs)
                monkeypatch.setattr("builtins.input", lambda *a: next(feed))
            rc = mod.main(argv + (CPU if pkg == "port" and argv[0] in (
                "chat", "ingest") else []))
            text = capsys.readouterr().out.replace(data, "<data>")
            out[pkg] = (rc, re.sub(r"\d+\.\d+s\b", "<t>s", text))
        return out
    return run


def test_cli_info_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ORAG_DATA_DIR", str(tmp_path / "data"))
    outs = []
    for mod, argv in ((jax_cli, ["info"]), (cli, ["info"] + CPU)):
        assert mod.main(argv) == 0
        outs.append(dict(line.split(": ", 1) for line in
                         capsys.readouterr().out.splitlines()))
    want, got = outs
    assert got.keys() == want.keys() == {"backend", "devices", "data_dir",
                                         "encoder", "health"}
    for key in ("backend", "data_dir", "encoder"):
        assert got[key] == want[key], key
    assert got["devices"] == "['cpu']"
    assert "'healthy': True" in got["health"] and \
        "'healthy': True" in want["health"]


def test_cli_info_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["info"])


def test_cli_ingest_files_and_errors_match_jax(tmp_path, both, capsys):
    good = tmp_path / "doc.md"
    good.write_text("# Title\nThe MXU is a systolic array that multiplies.")
    bad = tmp_path / "doc.xyz"
    bad.write_text("x")
    out = both(["ingest", str(good), str(bad)], capsys)
    assert out["port"] == out["jax"]
    rc, text = out["port"]
    assert rc == 0
    assert "ok  " in text and "ERR" in text and "unsupported" in text


def test_cli_ingest_directory_matches_jax(tmp_path, both, capsys):
    d = tmp_path / "docs"
    d.mkdir()
    (d / "a.txt").write_text("alpha document about tpus and matrices")
    (d / "b.txt").write_text("beta document about databases and vectors")
    out = both(["ingest", str(d)], capsys)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0 and out["port"][1].count("ok  ") == 2


def test_cli_chat_scripted_matches_jax(both, capsys):
    out = both(["chat"], capsys,
               inputs=["What is anything?", "memory", "stats", "exit"])
    assert out["port"] == out["jax"]
    rc, text = out["port"]
    assert rc == 0
    assert "Assistant:" in text
    assert "<persona>" in text          # memory command
    assert "rerank:" in text            # stats command


def test_ingest_then_restart_then_chat_matches_jax(tmp_path, both, capsys):
    """Index state survives a process restart (snapshot + reload) in both
    packages, with the same answer."""
    doc = tmp_path / "doc.md"
    doc.write_text("The MXU is a 128x128 systolic array that multiplies "
                   "matrices in bfloat16.")
    out = both(["ingest", str(doc)], capsys)
    assert out["port"] == out["jax"]
    assert "index snapshot" in out["port"][1]
    out = both(["chat"], capsys,
               inputs=["What is the MXU systolic array?", "exit"])
    assert out["port"] == out["jax"]
    text = out["port"][1]
    assert "systolic" in text.lower() and "128x128" in text


def test_env_example_matches_jax_but_the_package_line(tmp_path, capsys):
    texts = []
    for mod, name in ((jax_cli, "jax"), (cli, "port")):
        path = tmp_path / f"{name}.env"
        assert mod.main(["env-example", "--output", str(path)]) == 0
        assert capsys.readouterr().out.startswith(f"wrote {path} (")
        texts.append(path.read_text().splitlines())
    want, got = texts
    assert len(got) == len(want) > 100
    differ = [j for j, (a, b) in enumerate(zip(got, want)) if a != b]
    assert differ == [1]
    assert got[1] == ("# Generated by: python -m optimized_rag_tpu_torch "
                      "env-example")
    assert sum(line.startswith("# ORAG_") for line in got) > 100


def test_hitl_list_approve_reject_match_jax(tmp_path, monkeypatch, capsys):
    outs = {}
    for mod, Store, pkg in ((jax_cli, JaxStore, "jax"),
                            (cli, MetadataStore, "port")):
        data = tmp_path / pkg
        monkeypatch.setenv("ORAG_DATA_DIR", str(data))
        store = Store(os.path.join(str(data), "metadata.db"))
        agent_id = Settings().agent_id
        for j in range(3):
            store.hitl_enqueue(agent_id, f"question {j} " * 12,
                               f"answer {j} " * 30, 0.5 + j / 10, 0.25 * j)
        seen = []
        for argv in (["hitl", "list"], ["hitl", "approve", "1"],
                     ["hitl", "reject", "2", "--note", "wrong"],
                     ["hitl", "approve", "2"], ["hitl", "list"],
                     ["hitl", "list", "--status", "approved"],
                     ["hitl", "list", "--status", "rejected"],
                     ["hitl", "reject", "99"]):
            rc = mod.main(argv)
            seen.append((rc, capsys.readouterr().out))
        outs[pkg] = seen
    assert outs["port"] == outs["jax"]
    assert [rc for rc, _ in outs["port"]] == [0, 0, 0, 1, 0, 0, 0, 1]
    assert outs["port"][0][1].count("Q: question") == 3
    assert outs["port"][4][1].count("Q: question") == 1


SMALL_WIDTHS = {"ORAG_ENCODER_HIDDEN_DIM": "32", "ORAG_ENCODER_DIM": "32",
                "ORAG_ENCODER_NUM_LAYERS": "1", "ORAG_ENCODER_NUM_HEADS": "4",
                "ORAG_ENCODER_MLP_DIM": "64", "ORAG_ENCODER_VOCAB_SIZE": "2048",
                "ORAG_CROSS_ENCODER_HIDDEN_DIM": "32",
                "ORAG_CROSS_ENCODER_NUM_LAYERS": "1",
                "ORAG_CROSS_ENCODER_NUM_HEADS": "4",
                "ORAG_CROSS_ENCODER_MLP_DIM": "64"}


def test_train_and_local_lm_run_against_the_jax_cli(tmp_path, monkeypatch,
                                                   capsys):
    """``train`` (item 9's training half, which used to raise) runs on the
    CPU: ``train --device cpu --steps 2 --batch 8 --no-decoder`` at widths
    set through the environment prints the JAX CLI's lines (the corpus,
    the losses' keys, the recall@10 line, the checkpoint directory) and
    writes <data_dir>/models, which the JAX package's ``load_pretrained``
    reads and the port's agent then finds; without a card it needs
    ``--device cpu``. ``--local-lm`` (item 9's serving half) builds the JAX
    package's provider from the same checkpoint: the grounded generator
    from ORAG_LOCAL_LM_CKPT, else the decoder of the checkpoint directory
    the agent finds, else a random-init decoder; ``chat --local-lm`` starts
    with the JAX CLI's output."""
    from optimized_rag_tpu.models import pretrain as j_pretrain
    for key, val in SMALL_WIDTHS.items():
        monkeypatch.setenv(key, val)
    if not torch.cuda.is_available():
        monkeypatch.setenv("ORAG_DATA_DIR", str(tmp_path / "nowhere"))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--steps", "1"])
    outs = {}
    for pkg, mod, extra in (("jax", jax_cli, []), ("port", cli, CPU)):
        data = str(tmp_path / pkg)
        monkeypatch.setenv("ORAG_DATA_DIR", data)
        argv = ["train", "--steps", "2", "--batch", "8", "--no-decoder"]
        assert mod.main(argv + extra) == 0
        outs[pkg] = capsys.readouterr().out.replace(data, "<data>")
    masked = {pkg: re.sub(r"\d+\.\d+", "<x>", text).splitlines()
              for pkg, text in outs.items()}
    assert [ln for ln in masked["port"] if "step" not in ln] == \
        [ln for ln in masked["jax"] if "step" not in ln]
    assert "synthetic recall@10: trained=" in outs["port"]
    assert "checkpoints -> <data>/models" in outs["port"]
    models = tmp_path / "port" / "models"
    for name in ("biencoder", "crossencoder"):
        cfg, _ = j_pretrain.load_pretrained(str(models), name)
        assert cfg.hidden_dim == 32 and cfg.num_layers == 1
    assert not (models / "decoder.params.npz").exists()
    settings = Settings.from_env()
    settings.data_dir = str(tmp_path / "port")
    settings.flags.enable_metrics_export = False
    agent = RAGAgent(settings, llm=DeterministicLLM(), device="cpu")
    assert agent.embedder.cfg.hidden_dim == 32        # the trained ones
    assert agent.cross_encoder.cfg.hidden_dim == 32
    for key in SMALL_WIDTHS:
        monkeypatch.delenv(key)
    monkeypatch.setenv("ORAG_DATA_DIR", str(tmp_path / "data"))
    empty = tmp_path / "no_checkpoint"
    empty.mkdir()
    for ckpt in (os.path.join(REPO, "checkpoints", "grounded_r5"), None,
                 str(empty)):
        if ckpt is None:
            monkeypatch.delenv("ORAG_LOCAL_LM_CKPT", raising=False)
        else:
            monkeypatch.setenv("ORAG_LOCAL_LM_CKPT", ckpt)
        got = cli._local_lm_provider(Settings.from_env(), device="cpu")
        said = capsys.readouterr().out
        want = jax_cli._local_lm_provider(Settings.from_env())
        assert said == capsys.readouterr().out
        assert type(got).__name__ == type(want).__name__
        gen, j_gen = got.generator, want.generator
        assert type(gen).__name__ == type(j_gen).__name__
        assert (gen.max_prompt_len, gen.max_new_tokens, gen.cfg.num_layers,
                gen.cfg.hidden_dim) == (j_gen.max_prompt_len,
                                        j_gen.max_new_tokens,
                                        j_gen.cfg.num_layers,
                                        j_gen.cfg.hidden_dim)
        assert gen.device.type == "cpu"
    monkeypatch.setenv("ORAG_LOCAL_LM_CKPT",
                       os.path.join(REPO, "checkpoints", "grounded_r5"))
    outs = []
    for mod, argv in ((jax_cli, ["chat", "--local-lm"]),
                      (cli, ["chat", "--local-lm"] + CPU)):
        monkeypatch.setattr("builtins.input", lambda *a: "exit")
        assert mod.main(argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1].startswith("local LM: loaded grounded checkpoint")
    agent = cli.build_agent(Settings.from_env(), local_lm=True, device="cpu")
    assert type(agent.llm).__name__ == "GroundedProvider"


def test_build_agent_on_the_cpu_loads_the_snapshot(tmp_path, monkeypatch,
                                                   capsys):
    """The real ``build_agent`` (the pretrained encoders it finds) ingests
    on the CPU, and a second one restores the snapshot."""
    monkeypatch.setenv("ORAG_DATA_DIR", str(tmp_path / "data"))
    doc = tmp_path / "doc.txt"
    doc.write_text("The MXU is a 128x128 systolic array that multiplies "
                   "matrices in bfloat16.")
    assert cli.main(["ingest", str(doc)] + CPU) == 0
    assert "corpus size 1;" in capsys.readouterr().out
    agent = cli.build_agent(Settings.from_env(), device="cpu")
    assert agent.device.type == "cpu" and agent.dense.size == 1
    assert agent.dense.device.type == "cpu"


def test_python_m_runs_the_port_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['optimized_rag_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('optimized_rag_tpu_torch',"
            " run_name='__main__', alter_sys=True)\n"
            "except SystemExit as exc:\n"
            "    assert exc.code == 0, exc.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'flax', 'optimized_rag_tpu')]\n"
            "print('loaded:', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: optimized_rag_tpu_torch" in out.stdout
    for sub in ("chat", "ingest", "info", "env-example", "serve", "hitl",
                "train"):
        assert sub in out.stdout
    assert out.stdout.strip().endswith("loaded: []")
    out = subprocess.run([sys.executable, "-m", "optimized_rag_tpu_torch",
                          "serve", "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout
