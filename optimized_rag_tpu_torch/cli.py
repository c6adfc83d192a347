"""CLI: chat REPL + ingest + info + train commands, and the HTTP server.

Held against ``optimized_rag_tpu/cli.py``: the same subcommands, flags and
output. Every subcommand that computes (``chat``, ``ingest``, ``serve``,
``info`` and ``train``) also takes ``--device`` ("cuda" by default, or
"cpu"); without a card they raise unless given ``--device cpu``.

  python -m optimized_rag_tpu_torch chat
  python -m optimized_rag_tpu_torch ingest <path> [path ...]
  python -m optimized_rag_tpu_torch info
  python -m optimized_rag_tpu_torch serve --port 8080
  python -m optimized_rag_tpu_torch train --steps 300 --batch 64

The hidden ``--local-lm`` flag of ``chat`` and ``serve`` generates with
the repo's own checkpoints on the device (``ORAG_LOCAL_LM_CKPT``, else the
checkpoint directory the agent finds). ``train`` pretrains the encoders
(and the decoder LM unless ``--no-decoder``) on the ingested chunks plus
the synthetic corpus, writes them to ``--out`` (default
``<data_dir>/models``, where the agent finds them) in the JAX package's
checkpoint layout, and reports recall@10 trained against random-init.
"""

from __future__ import annotations

import argparse
import os
import sys

from optimized_rag_tpu_torch.config import Settings
from optimized_rag_tpu_torch.utils.logging_config import setup_logging

def _local_lm_provider(settings: Settings, device="cuda"):
    """The on-device generation provider of a trained checkpoint
    (ORAG_LOCAL_LM_CKPT, <data_dir>/models, or the bundled checkpoints).

    Preference order: the GROUNDED pointer-generator (models/grounded.py,
    no extractive fallback on the generate task), then the plain decoder,
    then a random-init generator (serving-path completeness only)."""
    from optimized_rag_tpu_torch.models.pretrain import (
        find_checkpoint_dir, load_pretrained)
    ckpt_dir = os.environ.get("ORAG_LOCAL_LM_CKPT") \
        or find_checkpoint_dir(settings.data_dir)
    grounded = load_pretrained(ckpt_dir, "grounded") if ckpt_dir else None
    if grounded is not None:
        from optimized_rag_tpu_torch.models.grounded import (
            GroundedGenerator, GroundedProvider)
        cfg, params = grounded
        print(f"local LM: loaded grounded checkpoint from {ckpt_dir}")
        gen = GroundedGenerator(
            cfg, params=params,
            max_prompt_len=min(cfg.prompt_len, cfg.max_seq_len
                               - cfg.target_len),
            max_new_tokens=cfg.target_len, device=device)
        return GroundedProvider(gen, fallback=DeterministicLLM_from(settings))
    from optimized_rag_tpu_torch.models.decoder import (
        DecoderConfig, Generator, LocalLMProvider)
    loaded = load_pretrained(ckpt_dir, "decoder") if ckpt_dir else None
    if loaded is not None:
        cfg, params = loaded
        print(f"local LM: loaded decoder checkpoint from {ckpt_dir}")
    else:
        cfg, params = DecoderConfig(num_layers=4, max_seq_len=1024), None
        print("local LM: no checkpoint found; using random init "
              "(train one with: python -m optimized_rag_tpu train)")
    gen = Generator(cfg, params=params,
                    max_prompt_len=min(cfg.max_seq_len - 128, 768),
                    max_new_tokens=128, device=device)
    return LocalLMProvider(gen)


def DeterministicLLM_from(settings: Settings):
    from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
    return DeterministicLLM(
        min_weighted=settings.verification.extractive_min_weighted,
        min_coverage=settings.verification.extractive_min_coverage,
        min_evidence_mass=settings.verification
        .extractive_min_evidence_mass)


def build_agent(settings: Settings, offline: bool = True,
                local_lm: bool = False, device="cuda"):
    from optimized_rag_tpu_torch.agent.agent import RAGAgent
    from optimized_rag_tpu_torch.agent.llm import OpenAICompatibleLLM
    from optimized_rag_tpu_torch.store.db import MetadataStore

    llm = None
    api_base = os.environ.get("ORAG_LLM_API_BASE")
    if api_base and not offline:
        llm = OpenAICompatibleLLM(
            api_base, model=os.environ.get("ORAG_LLM_MODEL", "gpt-4o-mini"),
            api_key=os.environ.get("ORAG_LLM_API_KEY", ""))
    if llm is None and local_lm:
        llm = _local_lm_provider(settings, device)
    if llm is None:
        llm = DeterministicLLM_from(settings)
    store = MetadataStore(os.path.join(settings.data_dir, "metadata.db"))
    agent = RAGAgent(settings, llm=llm, store=store, device=device)
    agent.load_indexes()  # restore device-side indexes if snapshotted
    return agent


def cmd_chat(args) -> int:
    settings = Settings.from_env()
    agent = build_agent(settings, offline=not args.online,
                        local_lm=getattr(args, "local_lm", False),
                        device=args.device)
    print("optimized_rag_tpu chat — commands: 'memory', 'stats', 'exit'")
    while True:
        try:
            user = input("\nYou: ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not user:
            continue
        if user.lower() in ("exit", "quit"):
            return 0
        if user.lower() == "memory":  # reference main.py:45-60
            print(agent.memory.format_core_memory())
            continue
        if user.lower() == "stats":
            if agent.hierarchical:
                print("tiers:", agent.hierarchical.get_statistics())
            if agent.cost_tracker:
                print("cost:", agent.cost_tracker.get_summary())
            print("rerank:", agent.reranker.stats)
            continue
        resp = agent.chat(user)
        print(f"\nAssistant: {resp.answer}")
        print(f"  [factuality={resp.factuality_score:.2f}"
              f" support={resp.support_ratio:.2f}"
              f" confidence={resp.confidence:.2f}"
              f" tiers={resp.tiers_used}"
              f" {resp.metrics['latency_s']:.2f}s]")
        if resp.warnings:
            print(f"  warnings: {'; '.join(resp.warnings)}")


def cmd_ingest(args) -> int:
    settings = Settings.from_env()
    agent = build_agent(settings, device=args.device)
    total_chunks = 0
    for path in args.paths:
        if os.path.isdir(path):
            results = agent.ingestor.upload_directory(path)
        else:
            results = [agent.ingestor.upload_file(path)]
        for r in results:
            if r.get("ok"):
                total_chunks += r["chunks"]
                print(f"ok  {r.get('document_id')}: {r['chunks']} chunks, "
                      f"{r['kg_triples']} triples, {r['seconds']:.2f}s")
            else:
                print(f"ERR {r.get('path', '')}: {r.get('error')}")
    path = agent.save_indexes()
    print(f"total: {total_chunks} chunks; corpus size {agent.dense.size}; "
          f"index snapshot -> {path}")
    return 0


def cmd_train(args) -> int:
    """Pretrain bi-encoder + cross-encoder + decoder LM on the ingested
    corpus (plus the synthetic topic corpus) on ``--device`` and report
    trained-vs-random recall@10 on the synthetic eval."""
    from optimized_rag_tpu_torch.device import resolve_device
    from optimized_rag_tpu_torch.models.decoder import DecoderConfig
    from optimized_rag_tpu_torch.models.encoder import (
        EmbeddingService, TransformerConfig)
    from optimized_rag_tpu_torch.models import pretrain
    from optimized_rag_tpu_torch.store.db import MetadataStore

    device = resolve_device(args.device)
    settings = Settings.from_env()
    out_dir = args.out or os.path.join(settings.data_dir, "models")
    # Real chunks from the ingested store, when any exist.
    store = MetadataStore(os.path.join(settings.data_dir, "metadata.db"))
    rows = store.execute("SELECT content FROM chunks LIMIT 5000")
    extra = [r[0] for r in rows]
    texts = pretrain.default_corpus(extra)
    print(f"training corpus: {len(texts)} chunks "
          f"({len(extra)} ingested + synthetic)")
    e = settings.encoder
    enc_cfg = TransformerConfig(
        vocab_size=e.vocab_size, hidden_dim=e.hidden_dim,
        num_layers=e.num_layers, num_heads=e.num_heads, mlp_dim=e.mlp_dim,
        max_seq_len=128, out_dim=e.dim)
    c = settings.cross_encoder
    cross_cfg = TransformerConfig(
        vocab_size=e.vocab_size, hidden_dim=c.hidden_dim,
        num_layers=c.num_layers, num_heads=c.num_heads, mlp_dim=c.mlp_dim,
        max_seq_len=128)
    dec_cfg = DecoderConfig(hidden_dim=256, num_layers=4, num_heads=4,
                            mlp_dim=1024, max_seq_len=1024) \
        if not args.no_decoder else None
    losses = pretrain.pretrain_all(
        out_dir, texts, encoder_cfg=enc_cfg, cross_cfg=cross_cfg,
        decoder_cfg=dec_cfg, steps=args.steps, batch=args.batch,
        device=device)
    print("losses:", losses)

    # Trained-vs-random recall@10 on the synthetic eval.
    from optimized_rag_tpu_torch.eval.synthetic import (
        evaluate_retriever, make_dataset)
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    ds = make_dataset(num_docs=400, num_topics=20, num_queries=40,
                      seed=99)

    def recall_with(service):
        idx = DenseIndex(dim=service.dim, capacity_block=1024, tile=256,
                         device=device)
        idx.add(service.encode(ds.texts))

        def retrieve(q, k):
            return idx.search(service.encode([q]), k).ids[0].tolist()
        return evaluate_retriever(retrieve, ds, k=10)["recall@10"]

    cfg_params = pretrain.load_pretrained(out_dir, "biencoder")
    trained = EmbeddingService(
        cfg_params[0], params=cfg_params[1], max_len=64,
        tokenizer=pretrain.load_tokenizer(out_dir,
                                          cfg_params[0].vocab_size, 64),
        device=device)
    random_init = EmbeddingService(enc_cfg, max_len=64, seed=7,
                                   device=device)
    r_trained = recall_with(trained)
    r_random = recall_with(random_init)
    print(f"synthetic recall@10: trained={r_trained:.3f} "
          f"random-init={r_random:.3f}")
    print(f"checkpoints -> {out_dir}")
    return 0


def cmd_env_example(args) -> int:
    """Regenerate .env.example from the live Settings schema (reference:
    .env.example documents every flag)."""
    lines = [
        "# optimized_rag_tpu environment configuration",
        "# Generated by: python -m optimized_rag_tpu_torch env-example",
        "# Every Settings field is overridable as ORAG_<SECTION>_<FIELD>;",
        "# tuples are comma-separated, dicts are JSON. All values below",
        "# are the defaults.", "",
        "# --- LLM endpoint (chat --online) ---",
        "# ORAG_LLM_API_BASE=http://localhost:8000/v1",
        "# ORAG_LLM_MODEL=gpt-4o-mini",
        "# ORAG_LLM_API_KEY=",
        "# ORAG_LOG_LEVEL=WARNING",
        "# ORAG_LOCAL_LM_CKPT=  # path to a trained decoder checkpoint",
        "",
        "# --- short aliases ---",
        "# ORAG_EMBED_DIM=384  ORAG_CHUNK_SIZE=1200",
        "# ORAG_CHUNK_OVERLAP=150  ORAG_TOP_K=10", "",
    ]
    section = None
    for sec, name, default in Settings.env_var_names():
        if sec != section:
            section = sec
            lines.append(f"# --- {sec} ---")
        lines.append(f"# {name}={default}")
    text = "\n".join(lines) + "\n"
    out = getattr(args, "output", None) or ".env.example"
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({len(lines)} lines)")
    return 0


def cmd_serve(args) -> int:
    """HTTP serving: /search (micro-batched), /chat, /healthz, /stats."""
    from optimized_rag_tpu_torch.server import AgentHTTPServer
    settings = Settings.from_env()
    agent = build_agent(settings, offline=not args.online,
                        local_lm=getattr(args, "local_lm", False),
                        device=args.device)
    agent.warmup()
    server = AgentHTTPServer(agent, host=args.host, port=args.port,
                             max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms)
    print(f"serving on http://{args.host}:{args.port} "
          f"(corpus: {agent.dense.size} chunks)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_hitl(args) -> int:
    """Inspect / resolve the human-in-the-loop review queue."""
    from optimized_rag_tpu_torch.store.db import MetadataStore
    settings = Settings.from_env()
    store = MetadataStore(os.path.join(settings.data_dir, "metadata.db"))
    if args.action == "list":
        items = store.hitl_list(settings.agent_id, status=args.status)
        if not items:
            print(f"no {args.status} items")
        for it in items:
            print(f"[{it['id']}] fact={it['factuality']:.2f} "
                  f"support={it['support_ratio']:.2f}  Q: {it['query'][:70]}")
            print(f"      A: {it['answer'][:120]}")
        return 0
    ok = store.hitl_review(args.item_id,
                           "approved" if args.action == "approve"
                           else "rejected", note=args.note)
    print("ok" if ok else f"no pending item {args.item_id}")
    return 0 if ok else 1


def cmd_info(args) -> int:
    import torch

    from optimized_rag_tpu_torch.device import resolve_device
    from optimized_rag_tpu_torch.utils.health import check_device_health
    settings = Settings.from_env()
    dev = resolve_device(args.device)
    names = ([torch.cuda.get_device_name(i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else ["cpu"])
    print(f"backend: {dev.type}")
    print(f"devices: {names}")
    print(f"data_dir: {settings.data_dir}")
    print(f"encoder: dim={settings.encoder.dim} "
          f"layers={settings.encoder.num_layers}")
    print(f"health: {check_device_health(timeout_s=90, device=dev)}")
    return 0


def _device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="device to run on: cuda (default) or cpu")


def main(argv=None) -> int:
    setup_logging(os.environ.get("ORAG_LOG_LEVEL", "WARNING"))
    p = argparse.ArgumentParser(prog="optimized_rag_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("chat", help="interactive chat REPL")
    pc.add_argument("--online", action="store_true",
                    help="use ORAG_LLM_API_BASE for generation")
    pc.add_argument("--local-lm", dest="local_lm", action="store_true",
                    help=argparse.SUPPRESS)  # demoted, as in the JAX CLI
    _device_flag(pc)
    pc.set_defaults(fn=cmd_chat)
    pt = sub.add_parser("train", help="pretrain encoder/reranker/LM "
                        "checkpoints on the ingested corpus")
    pt.add_argument("--steps", type=int, default=300)
    pt.add_argument("--batch", type=int, default=64)
    pt.add_argument("--out", default=None,
                    help="checkpoint dir (default <data_dir>/models)")
    pt.add_argument("--no-decoder", action="store_true")
    _device_flag(pt)
    pt.set_defaults(fn=cmd_train)
    pi = sub.add_parser("ingest", help="ingest files or directories")
    pi.add_argument("paths", nargs="+")
    _device_flag(pi)
    pi.set_defaults(fn=cmd_ingest)
    pn = sub.add_parser("info", help="environment info")
    _device_flag(pn)
    pn.set_defaults(fn=cmd_info)
    pe = sub.add_parser("env-example",
                        help="regenerate .env.example from Settings")
    pe.add_argument("--output", default=".env.example")
    pe.set_defaults(fn=cmd_env_example)
    ps = sub.add_parser("serve", help="HTTP server (/search /chat /stats)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8080)
    ps.add_argument("--max-batch", dest="max_batch", type=int, default=64)
    ps.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                    default=5.0)
    ps.add_argument("--online", action="store_true")
    ps.add_argument("--local-lm", dest="local_lm", action="store_true",
                    help=argparse.SUPPRESS)  # demoted, see chat above
    _device_flag(ps)
    ps.set_defaults(fn=cmd_serve)
    ph = sub.add_parser("hitl", help="review queue for gray-zone answers")
    ph.add_argument("action", choices=("list", "approve", "reject"))
    ph.add_argument("item_id", nargs="?", type=int, default=0)
    ph.add_argument("--status", default="pending")
    ph.add_argument("--note", default="")
    ph.set_defaults(fn=cmd_hitl)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
