#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: the /search serving path,
the retrieval half of a chat turn, the components a chat turn consumes, the
agent's chat turns, the CLI and HTTP server, IVF, sharded retrieval over a
device mesh, the local generators behind ``--local-lm``, training, the
eval tools, tensor-parallel training, and the reference benchmark's
retrieval path.

    python3 chip_smoke.py            # from any directory; needs one CUDA card

Phases, each printing one JSON line with its seconds:

1. ``device``  the card, and its name and power limit from nvidia-smi;
2. ``build``   nvcc builds the top-k kernels (optimized_rag_tpu_torch/csrc)
               into build/torch_kernels/ while g++ builds the C++ analyzer
               (native/analyzer.cpp) into build/native/; ctypes loads both;
3. ``kernels`` each kernel against its plain PyTorch twin, N=262,144, D=384,
               B in {1, 64, 1024} at tile 1024 and B=1024 at tile 4096,
               with times: K1 packed scan, K4 union extraction and K6 tile
               top-k over f32 and bf16 rows (K1's words held by value and
               by the row their column bits name), F (the scan floor) over
               bf16 rows, then K3, K5b (bit for bit), K7, K2 (held as K1)
               and K5a (as K4) over int8 rows; then the tensor-core scan's
               raw sums on adversarial operands within the rounding bound
               of csrc/scan_mma.cuh (D=128 and 384, full and split): K1's
               main loop over bf16 rows and K2's over int8 codes (raw,
               and scaled at mixed row scales);
4. ``slice_f32``  the pretrained BiEncoder embeds the qa_docs chunks into a
               DenseIndex filled to 4,194,304 rows (6.4 GB f32) with clustered
               synthetic rows and contiguous near-duplicate runs; a
               QueryServer answers 256 queries from 8 client threads in
               bursts, then 256 in closed loop; every answer must have the
               chunked exact f32 oracle's ids; a 131,072-row index routes to
               K6 alone; 64 queries go one at a time through the certified
               search, and each answer its certificate passes is held against
               the oracle; a forced fallback repairs its uncovered pairs
               (K4p), and with every pair named reruns K6;
5. ``slice_bf16`` the same rows in bf16 storage through DenseIndex.search,
               held against the plain bf16-scan, top-40, f32-rescore
               pipeline, and its certified answers one query at a time;
6. ``slice_int8`` int8 storage: 16,777,216 rows (6.44 GB of codes, 4x the
               f32 slice's rows in the same bytes) filled by the same
               generator, quantize_int8 on the card held bit for bit against
               the CPU over every query and three of the 17 blocks of rows
               (the chunks', the first synthetic and the last; every block's
               stored codes held against quantize_int8 on the card); the
               same two QueryServer loads, a direct search of 64 queries
               and a 131,072-row index (K7 alone); every answer held
               against the oracle of the route its batch took (certified,
               and fallback, whose uncovered pairs K4p repairs: exact
               int8-native scores; direct: K7's scoring, differences allowed
               only at a near-tied cc-th candidate, counted); 64 queries
               alone through the certified int8 search; recall@10 against
               the f32 oracle of the unquantized rows printed, not gated;
7. ``slice_hybrid`` the retrieval half of a chat turn: 262,144 chunks (the
               qa_docs chunks and seeded 40-word filler chunks of their own
               words, created over the last 365 days) embedded by the
               pretrained BiEncoder on the card in batches of 128 into a
               float32 DenseIndex (tile 1024) and added to a LexicalIndex
               (the agent's defaults; the add counts terms in the C++
               analyzer, as the JAX package's does); 64 queries one at a time through
               HybridRetriever's one-call route (the encoder forward inside
               encode_and_retrieve) and two-call route (dual_topk, then
               fuse_candidates), dense_only at k=2 (certified: K1 -> K4)
               and k=10 (K6), the separate-dispatch route after 16 deletes
               (K6 at k = 66), and FusedRerankEval with the pretrained
               cross-encoder (checkpoints/pretrained/crossencoder.params.npz)
               in modes ce and emb beside the modular SelectiveReranker;
               every answer held against a float64 numpy oracle (ids equal
               unless the oracle shows a near-tie of 1e-5, fused scores
               within 1e-5), the two hybrid routes against each other, the
               MMR selection, relevance and pairwise cosine against a numpy
               oracle, fused against modular, the card's cross-encoder
               logits against the port's CPU run; per-route host ms, per-stage
               CUDA-event ms, ingest and lexical build seconds;
8. ``slice_components`` the components a chat turn's nodes consume, with
               the same encoder: (a) the C++ analyzer against the Python one
               (two LexicalIndexes over slice_hybrid's 262,144 chunks: equal
               postings, built arrays and 64 searches, except where a
               document's stems share a hashed id: there the C++ count is
               their sum and the Python one the last stem's, as in the JAX
               package, and such documents are counted; the hashing and the
               pretrained learned-vocabulary tokenizers on the qa_docs chunks
               and 4,096 fillers: equal ids); (b) archival memory:
               MemoryManager over MetadataStore(":memory:") and an
               EmbedBatcher, 65,536 archived 40-word notes in batches of 128,
               64 archival_memory_search calls one at a time (top_k 5; K6 at
               N=65,536), one insert (the index grows to 69,632 rows) and 64
               more (K6 at 69,632), every answer held against a float64
               oracle over the index's rows; (c) EmbedBatcher: 8 clients x
               16 requests of 1-24 texts, coalesced, against the same load
               encoded directly (cosine >= 0.9999, unit rows, fewer
               dispatches than requests); (d) ConsistencyChecker over 16
               sets of 10 qa_docs sentences with negated and renumbered
               copies, and semantic dedup of 512 texts with
               near-duplicates, their pairwise cosine on the card held
               against float64 (ties within 1e-6 of a threshold counted);
               (e) snapshots (index/snapshot.py) of the archival index, a
               262,144-row corpus DenseIndex of slice_hybrid's rows and the
               native LexicalIndex, loaded back onto the card: 64 searches
               each (K6; k=2 certified: K1 -> K4; BM25) bit-identical
               before and after; (f) select_index_kind / build_index_for,
               check_device_health, a device_trace of 16 archival searches
               that must name K6's kernel once per launch (less one at the
               window's edge), and the StageTimer spans;
9. ``slice_agent`` the agent and one chat turn: RAGAgent(Settings()
               defaults, device="cuda") with the pretrained encoders runs
               the 16-node graph with the deterministic LLM and an offline
               web tool: (a) the reference's turn probe (bench.py:640-683:
               make_dataset(128 docs, 10 topics, seed 11) ingested in
               groups of 64, warmup(), 4 warm-up and 16 timed turns; host
               p50/p99, each node's p50 span, the device's busy and idle
               share under torch.profiler, kernel launches per turn beside
               its tiers); (c) the same agent after 65,536 archival notes:
               16 more turns, every one launching K6 over the notes, its
               archival hits held against a float64 oracle; (b) a fresh
               agent uploads the qa_docs and answers 8 questions in one
               session (each intent, the KG's two-hop chain, a recall
               question, a refusal); a CPU agent replays (b) and (a) up to
               its 8th timed turn, each turn's trace, intent, refusal,
               sources, citations and answer equal to the card's unless
               the CPU run shows a near-tie (a cosine within 1e-6 of a
               verification threshold, cross-encoder logits within 0.35,
               fused scores within 1e-4; counted); ``time.time`` is pinned
               for the phase, so both runs read one clock;
10. ``slice_serve`` the entry points as a user runs them: a data
               directory and a directory of the qa_docs and seeded filler
               files (slice_hybrid's 40-word fillers) that the agent's ingest
               turns into exactly 65,536 chunks; ``python -m
               optimized_rag_tpu_torch`` in subprocesses from the repo root:
               ``info`` (the card's name, health ok), ``ingest`` of the
               directory (every file ok, the corpus size and snapshot path),
               ``chat`` (three qa_docs questions, ``memory``, ``stats``,
               ``exit`` on stdin), ``serve --port P`` (/healthz on the card
               with the corpus size, /stats, 8 /search and 2 /chat, then
               SIGINT); in process, ``cli.build_agent(device="cuda")`` over
               the snapshot behind ``AgentHTTPServer``: 256 warm-up /search
               requests, 256 in bursts of 8 from 8 client threads, a 5 s
               closed loop of 8 clients (k=10, bench.py:684-760's load over
               HTTP), every answer held against the float64 oracle over the
               snapshot's rows (near-ties of 1e-5 counted), qps, p50, p99;
               slice_agent (b)'s 8 questions over /chat, replayed through a
               CPU agent over a copy of the data directory behind its own
               server (every reply equal, floats within 0.35 / 4, near-ties
               excused and counted); 4 concurrent /chat clients with
               ``concurrent_chat`` (every reply complete, the EmbedBatcher
               making fewer dispatches than requests); K6 counted on the
               /search and /chat paths;
11. ``slice_ivf`` IVF on the card: (a) the reference's IVF benchmark shape
               (benchmarks/bench_sharded.py:23-73): 10,485,760 x 128 bf16
               rows around 4,096 seeded centres, IVFIndex(4096 clusters,
               nprobe 128, 6 k-means iterations, tile 2048) built unbalanced
               (k-means, assignment and sort timed apart), 64 perturbed
               corpus rows, nprobe in {8, 16, 32, 64, 128}: the probed
               clusters against a float64 ranking of the centroids, every
               answer against the float64 top-10 of its probe plan, the
               layout (counts, starts, permutation) checked; recall@10
               against the exact top-10, qps per nprobe and the port's exact
               search of the batch printed; (b) the agent's upgrade past
               ``ivf_min_size`` (32,768) over slice_serve's snapshot: the
               balanced default IVF (1,024 clusters, nprobe 64, its cap and
               window checked), a fresh file ingested, 64 ``dense_only``
               queries held against the probe plan unioned with the exact
               tail (the fresh tail found), 8 chat turns replayed by a CPU
               agent that takes the card's IVF through ``state_dict``;
12. ``slice_sharded`` sharded retrieval over a 4-way data mesh (distinct
               cards where the machine has them, else all four shards on
               this card, one stream): (a) ShardedDenseIndex (bf16, tile
               1024) bulk-built on the card from slice_ivf's 10,485,760 x
               128 rows, 2,621,440 rows a shard; B=64 and B=1024 at k=10
               with impl "kernel" (topk_verified: K6 at tile_k 2 on every
               shard) and "auto" (exact_topk; B=1024 in batches of 64),
               every answer against the chunked exact float32 search of
               the stored rows (near-ties of 1e-5 counted); K6 launches per
               path, host syncs per search, ms and qps; (b)
               ShardedIVFIndex (4,096 clusters, 6 iterations, tile 2048)
               over the same rows, nprobe 8-128, every answer against the
               float64 top-10 of the shards' probe plans, recall@10; (c) the
               agent's sharded upgrade (data_parallel 4, shard_min_size
               32,768) over slice_serve's 65,536 chunks, 64 dense_only
               queries against a float64 oracle, 8 chat turns replayed by a
               CPU agent sharded over 4 logical CPU devices;
13. ``slice_local_lm`` the generators behind ``--local-lm``: (a)
               GroundedGenerator on checkpoints/grounded_r5 (prompt 1,792,
               up to 384 new tokens, greedy) over 8 prompts rendered from
               qa session questions and their retrieved chunks: prefill ms,
               decode ms a step, tokens/s at B=1 and B=8, the device's idle
               share over decode; 4 prompts replayed on the CPU (tokens
               equal up to a counted near-tie of 1.0 in log-prob); (b)
               Generator on checkpoints/pretrained/decoder (prompt 768, 128
               new), the same timings, 2 prompts replayed; (c) ``chat
               --local-lm --device cuda`` in process (ORAG_LOCAL_LM_CKPT
               naming the grounded checkpoint, two questions on stdin) over
               the qa_docs, then two RAGAgent turns with the
               GroundedProvider replayed by a CPU agent;
14. ``slice_train`` training at the widths of the repo's checkpoints, from
               Flax-style initialisation seeded on the card (bf16 compute
               over float32 master weights, AdamW as optax computes it):
               (a) ``train_biencoder`` at checkpoints/pretrained's
               bi-encoder (6 layers, 384 wide, vocab 32,768, max_len 64,
               batch 64) over the qa_docs chunks and ``default_corpus()``,
               30 steps, its first 3 replayed on the CPU (losses within
               1e-2 relative, weights within what two AdamW runs' steps
               can add up to, about 6 lr, and their median within
               lr / 10), a data=2 mesh of two logical
               devices on the card from the same seed; (b)
               ``train_cross_encoder`` at the settings' cross-encoder (4
               layers, 384 wide; 60 steps) and (c) ``train_decoder`` at
               checkpoints/pretrained's decoder (4 layers, 256 wide, 1,024
               positions, batch 16; 10 steps), the first step of each
               replayed on the CPU; (d) ``GroundedTrainer`` from checkpoints/grounded_r5
               (prompt 1,792, target 384, batch 8, GroundedSampler rows over
               the qa_docs chunks), 5 steps, step 0's nll and copy loss
               replayed on the CPU (5e-2), each step's pre-clip gradient
               norm printed; every trainer's first batch scores a lower
               loss after training; (e) the trained bi-encoder written in
               the JAX layout with float16 storage and read back by
               ``load_biencoder`` on the card (cosine 0.9999 against the
               trainer's own forward over 64 training texts), and a
               ``TrainCheckpointer`` save, restore and one more step against
               the uninterrupted step; (f) ``train --device cuda --steps 20
               --batch 64`` in process over a data directory of the qa_docs,
               its recall@10 lines, and K6 of its recall check counted on the
               path ``train_recall`` and held against its twin; per trainer
               ms a step, tokens/s, MFU (6 x matmul parameters x tokens over
               989 TFLOP/s), peak memory and the device's idle share;
15. ``slice_eval`` the eval tools as a user runs them: (a)
               ``kg_eval.main(["--loopback", ...])``, every precision,
               recall, tp, fp and fn equal to docs/results_r5/kg_eval.json;
               (b) ``qa_sheet.main(["--device", "cuda",
               "--no-translation-xl", ...])``: QA_SHEET (31 items) over
               ``build_agent`` with the in-repo encoders, the four
               language sheets (34) online to a loopback
               ``MockOpenAIServer``, the same four with translation
               disabled; 16 of those turns replayed on the CPU by agents
               built the same way, each row equal unless the CPU run shows
               a near-tie (counted); the language sections' accuracies
               beside the reference's (qa_full.json, qa_nt.json); (c)
               ``main --local-lm`` with checkpoints/grounded_r5 over
               QA_SHEET, 4 turns replayed on the CPU (a generation step's
               near-tie counted, as in slice_local_lm); (d)
               ``encoder_gauntlet.run_gauntlet(device="cuda")`` at its
               defaults (300 gold chunks, 4 spans each, 8 negatives, a
               30,000-chunk pool of this machine's harvest, the bundled
               bi-encoder): 320 texts embedded again on the CPU (cosine
               0.9999), every dense top-10 against a float64 oracle over
               the card's embeddings, recall@1 and @10 of both channels
               beside the reference's (docs/results_r5/gauntlet.json, a
               larger harvest); the top-k kernels of (b)-(d) counted on
               the paths ``eval_sheet``, ``eval_local_lm`` and
               ``eval_gauntlet`` and held against their twins;
16. ``slice_tp`` tensor parallelism for training on this one card (both
               model positions name ``cuda:0``: two head parts and two
               partial sums a layer; at data=2 two copies, their gradients
               summed and both stepping; the code paths and not NVLink),
               float32:
               the bi-encoder at the bundled checkpoint's widths (384,
               6 layers, 12 heads, mlp 1,536; max_len 64, batch 64), 3
               steps at model=1, data=1 x model=2 and data=2 x model=2;
               the decoder at checkpoints/pretrained's widths and
               ``GroundedTrainer`` from checkpoints/grounded_r5, one step
               at model=1 and model=2; losses within 1e-5 relative,
               weights within what two AdamW runs can move them apart; ms
               a step and peak memory of each, the copies equal bit for
               bit at the end, and the bytes of weights and moments at
               each model position below model=1's whole;
17. ``bench_shape`` the reference benchmark's retrieval path at its full
               shape (bench.py:180-265, :540-575): 10,485,760 x 128 bf16
               rows (clustered, 300 near-duplicate runs), tile 4096, k=10,
               unit-normal queries in batches of 1024 and 512; the
               certified search (b1024, b512, two sub-batches of 512), ANN
               at oversample 32 (held against the same pipeline with the
               scan's twin; recall printed), the verified searches (tile
               1024 and the tile-4096 batch union), the same rows as int8
               codes on the int8-native (union 64, pad_r 26) and scaled
               (K2 -> K5a) routes, and F; every certified or verified answer
               equals its route's oracle, a nonzero certificate's rerun
               too, and its rerun is timed in the route's record; the batch
               cell's scan, dispatch_topk of 4,096 queries at k=40 (four
               sub-batches; K4p repairs the pairs a nonzero certificate
               leaves), held against the oracle up to near-tie swaps; qps
               and ms per route and batch. Every kernel call the
               routes make is recorded, and one call of each distinct
               shape is held against its twin and timed there.

Launch counts are set to 0 just before each path and read just after it.
Then the card's nvidia-smi line; one JSON line with an entry for each
kernel at each shape a user path gives it (the served slices' paths:
QueryServer rounds, DenseIndex.search and the small indexes; each shape of
bench_shape's routes; each shape of slice_hybrid's dense routes; each
shape of slice_components' archival and restored indexes; each shape
of slice_agent's turns; each shape of slice_serve's /search and
/chat; each shape slice_sharded's kernel searches gave a shard; each
shape the recall check of slice_train's ``train`` gave a kernel; and each
shape slice_eval's sheets and gauntlet gave a kernel), its
numbers measured at that shape and its
``launches`` counted on those paths alone (``launches_by_path`` gives each
path), its ``bound_share`` (bound_ms / ms) and its ``library_factor``
(ms / library_ms); and last the ``{"ok": true, ...}`` line. Any failure
raises: the traceback is printed and the exit code is not 0. A watchdog
interrupts the script after DEADLINE_S seconds.
"""

from __future__ import annotations

import _thread
import contextlib
import glob
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
QA_DOCS = os.path.join(HERE, "optimized_rag_tpu_torch", "eval", "qa_docs")
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Below a 1,200 s limit for the whole run: the host-bound phases took
# 1.45x longer on one machine than on another (379-549 s before
# slice_sharded).
DEADLINE_S = 900
SEED = 1234
DIM, TILE, GROUPS = 384, 1024, 8
N_BIG = 4_194_304                 # rows of the served index (6.4 GB in f32)
N_SMALL = 131_072                 # below 64*k tiles: routes straight to K6
N_KERNEL = 262_144                # rows of the kernels phase
CAPACITY_BLOCK = 65_536           # DenseIndex growth block, as the agent's
K = 10                            # what clients ask for
K_SERVED = 1 << (K - 1).bit_length()  # QueryServer's power-of-two bucket
CC_SERVED = 4 * K_SERVED          # int8 candidates: a 4x oversample
N_INT8 = 16_777_216               # rows of the int8 index (6.44 GB of codes)
N_QUERIES, N_CLIENTS = 256, 8
# The reference benchmark's retrieval shape (bench.py:180-183): 10,485,760
# x 128 bf16 rows, tile 4096, k 10, batches of 1024 and 512.
N_BENCH, DIM_BENCH, BENCH_TILE = 10_485_760, 128, 4096
B_HEAD, B_CMP = 1024, 512
# The batch cell's scan (portbench): 4,096 queries at k = 4 x 10.
B_BATCH, K_BATCH = 4096, 40
MAX_DEVICE_BYTES = 30e9
TIE_TOL = 1e-5                    # f32 scores: ~1e-7 summation-order drift
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 on the CUDA
# cores, bf16 on the tensor cores,
# int8 on the tensor cores.
PEAK_BW, PEAK_F32, PEAK_BF16, PEAK_INT8 = 3.35e12, 67e12, 989e12, 1979e12
_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def start_watchdog() -> None:
    """Interrupt the main thread at the deadline; if it is stuck in native
    code, end the process 30 s later."""
    def fire():
        print(f"chip_smoke: deadline of {DEADLINE_S} s passed", file=sys.stderr,
              flush=True)
        _thread.interrupt_main()
        time.sleep(30)
        os._exit(1)
    timer = threading.Timer(DEADLINE_S, fire)
    timer.daemon = True
    timer.start()


def median_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(
        1e-12)


# ------------------------------------------------------------------ data

def clustered_rows(n, gen, centers):
    """benchmarks/common.py:40-76 in torch: cluster centre * 2 + noise."""
    dev = centers.device
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen,
                           device=dev)
    return unit(centers[assign] + torch.randn(n, centers.shape[1],
                                              generator=gen, device=dev))


def near_duplicates(base, n, gen):
    """``n`` rows at cosine ~0.98 to ``base``: base + 0.2 * unit noise."""
    noise = unit(torch.randn(n, base.shape[0], generator=gen,
                             device=base.device))
    return unit(base[None, :] + 0.2 * noise)


def plan_runs(rng: random.Random, n_rows, first_row, n_runs):
    """Non-overlapping run slots [start, start+len), 32-row aligned so no
    run straddles a tile; lengths 8..32."""
    slots = rng.sample(range(-(-first_row // 32), n_rows // 32), n_runs)
    return sorted((s * 32, rng.randint(8, 32)) for s in slots)


def qa_chunks():
    out = []
    for path in sorted(glob.glob(os.path.join(QA_DOCS, "*.md"))):
        with open(path, encoding="utf-8") as f:
            out += [p.strip() for p in f.read().split("\n\n") if p.strip()]
    if not out:
        raise FileNotFoundError("no qa_docs chunks next to chip_smoke.py")
    return out


def make_queries(chunks, rng: random.Random, exclude=frozenset()):
    """N_QUERIES distinct sentences of the chunks, about 40% lightly
    reworded, none of them in ``exclude``."""
    sents = [s.strip() for c in chunks
             for s in re.split(r"(?<=[.?!])\s+|\n+", c) if len(s.split()) > 3]
    prefixes = ["tell me about", "what does the doc say on", "explain"]
    out, seen = [], set(exclude)
    for _ in range(100 * N_QUERIES):
        if len(out) == N_QUERIES:
            return out
        s = rng.choice(sents)
        if rng.random() < 0.4:
            words = s.lower().rstrip(".?!").split()
            s = f"{rng.choice(prefixes)} {' '.join(words[1:])}"
        if s not in seen:
            seen.add(s)
            out.append(s)
    raise ValueError(f"only {len(out)} distinct queries in the qa_docs")


# ------------------------------------------------------------- checking

def running_topk(score, size, k, m, dev, chunk=262_144):
    """Exact top-k of ``score(lo, hi)`` -> [M, hi-lo] over rows [0, size),
    chunk by chunk, ties to the lower row: [M, k] scores, ids."""
    best_s = torch.full((m, k), float("-inf"), device=dev)
    best_i = torch.full((m, k), -1, dtype=torch.long, device=dev)
    for lo in range(0, size, chunk):
        hi = min(size, lo + chunk)
        cand_s = torch.cat([best_s, score(lo, hi)], dim=1)
        cand_i = torch.cat([best_i, torch.arange(lo, hi, device=dev)
                            .expand(m, -1)], dim=1)
        best_s, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
        best_s, pos = best_s[:, :k], pos[:, :k]
        best_i = torch.gather(cand_i, 1, pos)
    return best_s, best_i


def oracle_topk(q, corpus, size, k, scan_dtype=torch.float32,
                chunk=262_144):
    """Chunked exact top-k, ties to the lower row: [B, k] scores, ids."""
    qs = q.to(scan_dtype).float()
    return running_topk(lambda lo, hi: qs @ corpus[lo:hi].float().T, size,
                        k, q.shape[0], q.device, chunk)


def int8_oracle(qn, c8, cs, size, k):
    """Top-k of an int8 corpus under both of the int8 search's scorings,
    ties to the lower row, for queries ``qn`` [M, D] normalised as the
    index normalised them. "certified": the int8-native score, a float32
    product of the codes (exact below 2**24), * cs, * qs; "k7": the tiled
    search's, bf16(q) x codes, an f32 sum, * cs."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    q8, qs = quantize_int8(qn)
    q8f, qb = q8.float(), qn.to(torch.bfloat16).float()
    m, dev = qn.shape[0], qn.device
    return {
        "certified": running_topk(
            lambda lo, hi: ((q8f @ c8[lo:hi].float().T) * cs[lo:hi])
            * qs[:, None], size, k, m, dev),
        "k7": running_topk(
            lambda lo, hi: (qb @ c8[lo:hi].float().T) * cs[lo:hi],
            size, k, m, dev)}


def rescore_oracle(qn, c8, cs, cand, kk):
    """Float32 rescore of dequantized candidate rows in rescore_topk's
    arithmetic (a batched matmul), top-kk, ties to the lower row."""
    cand = cand.sort(dim=1).values
    rows = c8[cand].float() * cs[cand][..., None]
    s = torch.bmm(rows, qn[:, :, None])[:, :, 0]
    s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :kk], torch.gather(cand, 1, pos[:, :kk])


def hold_route(what, route, ids, vals, oracle, qn, c8, cs, cc, kk):
    """Answers [B, >=k] of one int8 search against the oracle of the route
    it took. Certified or fallback (the pairs the covers left, repaired by
    K4p scoring as K5b): every id equal to the pipeline of exact int8-native
    scores, top-cc, f32 rescore, top-kk. Direct (K7): the same pipeline
    with K7's scoring; an answer may differ only where the oracle's cc-th
    and (cc+1)-th candidates score within TIE_TOL (K7 sums in another
    order). Returns the count of such boundary differences."""
    o_s, o_i = oracle["k7" if route == "direct" else "certified"]
    want_s, want_i = rescore_oracle(qn, c8, cs, o_i[:, :cc], kk)
    k = ids.shape[1]
    differ = (ids.long() != want_i[:, :k]).any(dim=1)
    edge = (o_s[:, cc - 1] - o_s[:, cc]).abs() <= TIE_TOL
    if route != "direct":
        check_answers(what, ids, vals, want_i[:, :k], want_s[:, :k])
        return 0
    bad = differ & ~edge
    if bool(bad.any()):
        j = int(bad.nonzero()[0, 0])
        check_answers(f"{what} (row {j}, {route})", ids[j:j + 1],
                      vals[j:j + 1], want_i[j:j + 1, :k],
                      want_s[j:j + 1, :k])
    same = ~differ
    if bool(same.any()):
        check_answers(f"{what} ({route})", ids[same], vals[same],
                      want_i[same, :k], want_s[same, :k])
    return int(differ.sum())


def check_selection(what, q, corpus, ids, vals, ids_ref, vals_ref,
                    tol=TIE_TOL, row_scale=None, rows_dtype=None):
    """A kernel's selections [S, k, B] (query b on the last axis) agree with
    its twin's.

    Scores must match within ``tol``. Ids must match, except where two rows
    score within the drift of two f32 summation orders (a near-tie): there
    the returned row must really score its value (rows rounded to
    ``rows_dtype``, then ``* row_scale``, for the scaled kernels). Returns
    (worst score error, count of near-tie swaps)."""
    err = float((vals - vals_ref).abs().max())
    if err > tol:
        raise AssertionError(f"{what}: scores differ by {err:.3g} > {tol}")
    mism = ids != ids_ref
    swaps = int(mism.sum())
    if swaps:
        qi = torch.arange(q.shape[0], device=q.device).expand_as(ids)
        sel = ids[mism].long()
        rows = corpus[sel] if rows_dtype is None else corpus[sel].to(
            rows_dtype)
        true = (rows.float() * q[qi[mism]]).sum(-1)
        if row_scale is not None:
            true = true * row_scale[sel]
        bad = float((true - vals[mism]).abs().max())
        if bad > tol:
            raise AssertionError(f"{what}: {swaps} ids differ and a returned "
                                 f"row scores {bad:.3g} off its value")
    # Live rows are distinct (padding rows all score -1e30 and may repeat).
    live = torch.where(vals > -1e29, ids.long(), -1 - torch.arange(
        ids.numel(), device=ids.device).view_as(ids))
    srt = live.sort(dim=1).values
    if not bool((srt[:, 1:] != srt[:, :-1]).all()):
        raise AssertionError(f"{what}: a row is selected twice")
    return err, swaps


def check_answers(what, ids, vals, ids_ref, vals_ref, tol=TIE_TOL):
    """Answers [B, k] against the oracle's: every id equal, scores within
    ``tol``. Returns the worst score error."""
    differ = ids.long() != ids_ref.long()
    if bool(differ.any()):
        where = differ.nonzero().tolist()
        rows = [(b, j, int(ids[b, j]), float(vals[b, j]), int(ids_ref[b, j]),
                 float(vals_ref[b, j])) for b, j in where[:8]]
        same_sets = all(set(ids[b].tolist()) == set(ids_ref[b].tolist())
                        for b in {b for b, _ in where})
        raise AssertionError(
            f"{what}: {len(where)} ids differ from the oracle's (same id "
            f"sets: {same_sets}); (query, rank, id, score, oracle id, oracle "
            f"score): {rows}")
    err = float((vals - vals_ref).abs().max())
    if err > tol:
        raise AssertionError(f"{what}: scores differ by {err:.3g} > {tol}")
    return err


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -------------------------------------------------------- kernel holding

LIB_ELEMS = 1 << 30               # largest [B, rows] yardstick score block


def kernel_kind(name):
    """"int8" (int8-native: K3, K5b), "scaled" (K2, K5a, K7) or "dense"."""
    return ("int8" if name.endswith("_int8")
            else "scaled" if name.endswith("_scaled") else "dense")


def call_operands(name, args):
    """A wrapper call's arguments, as ops/topk.py passes them, split into
    (queries or query codes, corpus, row scales, size, tile, m, tiles,
    arguments without the range flag); m is groups, rounds or tile_k."""
    kind = kernel_kind(name)
    if name == "scan_floor":
        q, corpus, tile = args
        return q, corpus, None, None, tile, 1, None, args
    if name == "extract_pairs":           # tiles: the pairs' tiles
        q, corpus, size, tile, m, pair_tile, _, *scales = args
        return (q, corpus, scales[0] if scales else None, size, tile, m,
                pair_tile, args)
    core = args
    if name.startswith("packed"):         # drop the range flag, if passed
        core = args[:{"dense": 5, "scaled": 6, "int8": 7}[kind]]
    if kind == "int8":
        q, _, corpus, cs, size, tile, m, *rest = core
    elif kind == "scaled":
        q, corpus, cs, size, tile, m, *rest = core
    else:
        (q, corpus, size, tile, m, *rest), cs = core, None
    tiles = rest[0] if name.startswith("extract") else None
    return q, corpus, cs, size, tile, m, tiles, core


def lib_scores(qs, rows):
    """The library yardstick's matmul: f32 GEMM for an f32 corpus, bf16
    GEMM (tensor cores, bf16 output) for a bf16 one."""
    if rows.dtype == torch.bfloat16:
        return torch.matmul(qs.to(torch.bfloat16), rows.transpose(-1, -2))
    return torch.matmul(qs, rows.transpose(-1, -2))


def int8_scores_lib(q8, rows8):
    """The int8 yardstick's matmul: ``torch._int_mm`` (cuBLASLt s8 x s8 ->
    s32) where its shape rules allow (more than 16 queries, widths a
    multiple of 8), else a float32 matmul of the codes."""
    try:
        return torch._int_mm(q8, rows8.T), "torch._int_mm"
    except RuntimeError:
        return q8.float() @ rows8.float().T, "float32 matmul of the codes"


def library_call(K_, name, q, corpus, cs, tile, m, tiles):
    """One PyTorch computation of the kernel's function on the same inputs,
    never called by the port: a GEMM (bf16 of bf16(q) and the rows as bf16,
    x scales, for the scaled kernels; ``torch._int_mm`` for the int8-native
    ones), then ``torch.topk`` (``amax`` for F) per tile. Over the whole
    corpus it runs in row blocks where one [B, N] score matrix would exceed
    LIB_ELEMS. Returns (callable, label)."""
    kind = kernel_kind(name)
    b, (n, d) = q.shape[0], corpus.shape
    if kind == "int8":
        score = lambda rows, rs: int8_scores_lib(q, rows.reshape(-1, d))[0]
        label = int8_scores_lib(q, corpus[:tile])[1]
        src = corpus
    elif kind == "scaled":
        q16 = q.to(torch.bfloat16)
        score = lambda rows, rs: torch.matmul(q16, rows.transpose(-1, -2)) \
            .mul_(rs)
        label = "bf16 torch.matmul, * scale"
        src = corpus.to(torch.bfloat16)   # made once, outside the timing
    else:
        qs = K_._scan_queries(q, corpus)
        score = lambda rows, rs: lib_scores(qs, rows)
        label = f"{'bf16' if corpus.dtype == torch.bfloat16 else 'f32'} " \
                "torch.matmul"
        src = corpus
    if tiles is not None:                 # the listed tiles: one call
        t_ids = tiles.long()
        sel = src.view(n // tile, tile, d)[t_ids]
        rs = None if cs is None else cs.view(n // tile, tile)[t_ids][:, None]
        if kind == "int8":
            return (lambda: torch.topk(score(sel, rs).view(b, -1, tile), m),
                    f"{label}, torch.topk")
        return lambda: torch.topk(score(sel, rs), m), f"{label}, torch.topk"
    reduce = ((lambda s: s.amax(dim=-1)) if name == "scan_floor"
              else (lambda s: torch.topk(s, m if name.startswith("tile")
                                         else 2)))
    step = n if b * n <= LIB_ELEMS else max(tile, LIB_ELEMS // b // tile
                                            * tile)

    def lib():
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            reduce(score(src[lo:hi], None if cs is None else cs[lo:hi])
                   .view(b, (hi - lo) // tile, tile))
    red = "amax per tile" if name == "scan_floor" else "torch.topk"
    blocks = "" if step == n else f", in blocks of {step} rows"
    return lib, f"{label}, {red}{blocks}"


def hold_call(K_, T_, name, args, reps, where, plain_reps=None):
    """Kernel ``name`` on ``args`` (a wrapper call as ops/topk.py makes it)
    against its plain twin on the same inputs, then timed beside the twin
    and the library yardstick. int8-native kernels bit for bit; packed
    words by value (one quantisation step) and by the row their column
    bits name; selections within TIE_TOL, near-tie swaps only; F within
    TIE_TOL. Returns the record: errors, ms, plain_ms, library_ms, bytes,
    flops, bound_ms, bound_by and the call's shape."""
    if name == "extract_pairs":
        return hold_pairs(K_, args, reps, where, plain_reps)
    kind = kernel_kind(name)
    q, corpus, cs, size, tile, m, tiles, core = call_operands(name, args)
    b, (n, d) = q.shape[0], corpus.shape
    kernel = lambda: getattr(K_, name)(*core)
    if kind == "int8":
        qt, plain_args = None, core
    else:
        qt = (K_._bf16_queries(q) if kind == "scaled"
              else K_._scan_queries(q, corpus))
        plain_args = (qt,) + tuple(core[1:])
    plain = lambda: getattr(K_, name + "_plain")(*plain_args)
    rows_dtype = (K_.scaled_rows_dtype(corpus) if kind == "scaled"
                  else None)
    out, ref = kernel(), plain()
    rec = {}
    if kind == "int8":
        differ = sum(int((a != r).sum()) for a, r in zip(
            out if isinstance(out, tuple) else (out,),
            ref if isinstance(ref, tuple) else (ref,)))
        if differ:
            raise AssertionError(f"{where} {name}: {differ} values differ "
                                 "from the twin's")
        rec.update(max_abs_err=0.0, tolerance=0.0)
        if name.startswith("packed"):     # K3: the sums are exact
            rec["score_diff"] = 0.0
    elif name.startswith("packed"):
        step = tile * 2.0 ** -22          # quantisation step on (2, 4)
        lb_err = float((T_._unpack_lb(out, tile) - T_._unpack_lb(ref, tile))
                       .abs().max())
        faults, boundary = K_.packed_word_faults(
            qt, corpus, size, tile, out, ref, drift=TIE_TOL, row_scale=cs,
            rows_dtype=rows_dtype, groups=m)
        if lb_err > step or faults:
            raise AssertionError(f"{where} {name}: lower bounds differ by "
                                 f"{lb_err:.3g} (step {step:.3g}), {faults} "
                                 "words name a wrong row or value")
        # The measured counterpart of the scan's accumulation bound: the
        # largest difference of the words' values where both name a row.
        same = (out & (tile - 1)) == (ref & (tile - 1))
        score_diff = float(torch.where(
            same, (T_._unpack_lb(out, tile) - T_._unpack_lb(ref, tile))
            .abs(), 0.0).max())
        rec.update(max_abs_err=lb_err, tolerance=step,
                   boundary_words=boundary, score_diff=score_diff)
    elif name == "scan_floor":
        err = float((out - ref).abs().max())
        if not err <= TIE_TOL:
            raise AssertionError(f"{where} scan_floor: {err:.3g} > {TIE_TOL}")
        rec.update(max_abs_err=err, tolerance=TIE_TOL, score_diff=err)
    else:
        (v, i), (v_p, i_p) = out, ref
        i, i_p = i.long(), i_p.long()
        if tiles is not None:             # tile-local columns
            base = (tiles.long() * tile)[:, None, None]
            i, i_p = i + base, i_p + base
        err, swaps = check_selection(f"{where} {name}", qt, corpus, i, v, i_p,
                                     v_p, row_scale=cs, rows_dtype=rows_dtype)
        rec.update(max_abs_err=err, tolerance=TIE_TOL, near_tie_swaps=swaps)
        del v, i, v_p, i_p
    del out, ref
    lib, label = library_call(K_, name, q, corpus, cs, tile, m, tiles)
    rec.update(ms=median_ms(kernel, reps),
               plain_ms=median_ms(plain, plain_reps or reps),
               library_ms=median_ms(lib, plain_reps or reps), library=label)
    del lib
    # Bytes: inputs read once, outputs written once; operations: 2*B*rows*D.
    # The kernels read only live rows (those below ``size``; F reads all).
    t = n // tile
    live = n if size is None else min(int(size), n)
    row_bytes = d * corpus.element_size() + (0 if cs is None else 4)
    q_bytes = b * (d + 4) if kind == "int8" else b * d * 4
    if tiles is not None:
        u = tiles.shape[0]
        rows = int((live - tiles.long() * tile).clamp(0, tile).sum())
        out_bytes = u * 4 + 2 * u * m * b * 4
    else:
        rows = live
        out_bytes = t * b * 4 * (1 if name == "scan_floor"
                                 else 2 * m if name.startswith("tile")
                                 else 2)
    peak = (PEAK_INT8 if kind == "int8" else PEAK_F32
            if kind == "dense" and corpus.dtype == torch.float32
            else PEAK_BF16)
    rec.update(bytes=rows * row_bytes + q_bytes + out_bytes,
               flops=2 * b * rows * d, B=b, N=n, live_rows=rows, D=d,
               tile=tile,
               m=m, U=None if tiles is None else tiles.shape[0])
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["flops"],
                                                peak)
    return rec


def hold_pairs(K_, args, reps, where, plain_reps=None):
    """K4p on ``args`` (``extract_pairs``'s, as ``repair_uncovered`` passes
    them) against its twin on the same inputs, each pair's list held as a
    selection of its query over its tile (int8-native bit for bit), then
    timed beside the twin and a library yardstick: each pair's tile
    gathered, a batched matmul with its query, ``torch.topk``. A block of
    up to 64 pairs of one tile reads the tile's live rows once. Returns the
    record ``hold_call`` returns, U the pairs' count."""
    q, corpus, size, tile, m, pt, pq, *scales = args
    row_scale, q_scale = (*scales, None, None)[:2]
    native = q.dtype == torch.int8
    if native:
        qt, rows_dtype = q, None
    elif row_scale is not None:
        qt, rows_dtype = K_._bf16_queries(q), K_.scaled_rows_dtype(corpus)
    else:
        qt, rows_dtype = K_._scan_queries(q, corpus), None
    kernel = lambda: K_.extract_pairs(*args)
    plain = lambda: K_.extract_pairs_plain(
        qt, corpus, size, tile, m, pt, pq, row_scale=row_scale,
        q_scale=q_scale, rows_dtype=rows_dtype)
    (v, i), (v_p, i_p) = kernel(), plain()
    if native:
        differ = int((v != v_p).sum()) + int((i != i_p).sum())
        if differ:
            raise AssertionError(f"{where} extract_pairs: {differ} values "
                                 "differ from the twin's")
        rec = {"max_abs_err": 0.0, "tolerance": 0.0}
    else:
        # One selection per pair, [1, rounds, P]: pair j's query is row j.
        base = (pt.long() * tile)[None, :]
        err, swaps = check_selection(
            f"{where} extract_pairs", qt[pq], corpus, (i.long() + base)[None],
            v[None], (i_p.long() + base)[None], v_p[None],
            row_scale=row_scale, rows_dtype=rows_dtype)
        rec = {"max_abs_err": err, "tolerance": TIE_TOL,
               "near_tie_swaps": swaps}
    del v, i, v_p, i_p
    n, d = corpus.shape
    t_ids = pt.long()
    rows3 = corpus.view(n // tile, tile, d)
    if corpus.dtype == torch.bfloat16 and not native and row_scale is None:
        qs, label = qt.to(torch.bfloat16), "bf16 torch.bmm"
    else:
        qs, label = qt.float(), "f32 torch.bmm"
    step = max(1, LIB_ELEMS // 4 // (tile * d))

    def lib():
        for lo in range(0, t_ids.shape[0], step):
            rows = rows3[t_ids[lo:lo + step]].to(qs.dtype)
            s = torch.bmm(rows, qs[pq[lo:lo + step]][:, :, None])[..., 0]
            if row_scale is not None:
                s = s * row_scale.view(n // tile, tile)[t_ids[lo:lo + step]]
            torch.topk(s, m)
    rec.update(ms=median_ms(kernel, reps),
               plain_ms=median_ms(plain, plain_reps or reps),
               library_ms=median_ms(lib, plain_reps or reps),
               library=f"{label} per pair, torch.topk")
    live = n if size is None else min(int(size), n)
    tile_live = (live - torch.arange(n // tile, device=pt.device) * tile
                 ).clamp(0, tile)
    blocks = -(-torch.bincount(t_ids, minlength=n // tile)
               // K_.SELECTION_QUERY_BLOCK)
    rows_read = int((blocks * tile_live).sum())
    scored = int(tile_live[t_ids].sum())
    p = t_ids.shape[0]
    row_bytes = d * corpus.element_size() + (0 if row_scale is None else 4)
    q_bytes = p * (d + 4) if native else p * d * 4
    peak = (PEAK_INT8 if native else PEAK_F32
            if corpus.dtype == torch.float32 and row_scale is None
            else PEAK_BF16)
    rec.update(bytes=rows_read * row_bytes + q_bytes + 2 * p * m * 4,
               flops=2 * scored * d, B=q.shape[0], N=n, live_rows=rows_read,
               D=d, tile=tile, m=m, U=p)
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], rec["flops"],
                                                peak)
    return rec


def pairs_call(T_, q, corpus, size, tile, rounds):
    """K4p's call as ``repair_uncovered`` makes it for ``q``: the pairs the
    covers leave open (or, where they certify ``q``, those one union slot
    leaves)."""
    for union in (32, 1):
        _, _, _, cover = T_._packed_search(q, corpus, rounds, size, tile,
                                           GROUPS, union, None, None, True,
                                           covers=True)
        pairs = cover.need.T.nonzero()
        if pairs.shape[0]:
            break
    return ("extract_pairs", (q, corpus, size, tile, rounds, pairs[:, 0],
                              pairs[:, 1]))


def dense_calls(q, corpus, size, tile, tiles, rounds, floor=False):
    """K1, K4 and K6 (and F) calls on a float corpus, as the search makes
    them."""
    calls = [("packed_extract", (q, corpus, size, tile, GROUPS)),
             ("extract", (q, corpus, size, tile, rounds, tiles)),
             ("tile_topk", (q, corpus, size, tile, rounds))]
    if floor:
        calls.append(("scan_floor", (q, corpus, tile)))
    return calls


def int8_calls(q, c8, cs, size, tile, tiles, rounds, scaled=False):
    """K3, K5b and K7 (and the scaled route's K2 and K5a) calls on an int8
    corpus."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    q8, qs = quantize_int8(q)
    calls = [("packed_extract_int8", (q8, qs, c8, cs, size, tile, GROUPS)),
             ("extract_int8", (q8, qs, c8, cs, size, tile, rounds, tiles)),
             ("tile_topk_scaled", (q, c8, cs, size, tile, rounds))]
    if scaled:
        calls += [("packed_extract_scaled", (q, c8, cs, size, tile, GROUPS)),
                  ("extract_scaled", (q, c8, cs, size, tile, rounds, tiles))]
    return calls


def hold_calls(K_, T_, calls, reps, where):
    """``hold_call`` of each (name, args); one record per kernel name."""
    return {name: hold_call(K_, T_, name, args, reps, where)
            for name, args in calls}


# ----------------------------------------------------------------- phases

def phase_device():
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})
    return name, smi


def phase_build():
    """nvcc builds the kernels, then g++ the C++ analyzer
    (native/analyzer.cpp into build/native/)."""
    from optimized_rag_tpu_torch import native
    from optimized_rag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    t1 = time.perf_counter()
    native.load_library()
    if not native.available():
        raise RuntimeError("the native analyzer did not build")
    usage = [ln.strip() for ln in _build.build_info["ptxas"].splitlines()
             if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc": _build.build_info["nvcc"],
          "library": os.path.relpath(_build.build_info["library"], HERE),
          "analyzer": os.path.relpath(native.library_path(), HERE),
          "analyzer_seconds": time.perf_counter() - t1,
          "ptxas": usage, "seconds": time.perf_counter() - t0})


def phase_kernels(K_, T_, dev):
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    centers = torch.randn(4096, DIM, generator=gen, device=dev) * 2.0
    corpus32 = clustered_rows(N_KERNEL, gen, centers)
    runs = plan_runs(random.Random(SEED), N_KERNEL, 0, 24)
    for start, length in runs:
        corpus32[start:start + length] = near_duplicates(corpus32[start],
                                                         length, gen)
    size = N_KERNEL - 300                     # a partial last tile
    b_max = 1024
    src = torch.tensor([s for s, _ in runs], device=dev)
    pick = torch.cat([src, torch.randint(0, size, (b_max,), generator=gen,
                                         device=dev)])[:b_max]
    q_all = unit(corpus32[pick] + 0.5 * unit(torch.randn(
        b_max, DIM, generator=gen, device=dev)))

    def union(tile):
        """32 tile ids, the tiles holding runs first."""
        hot = sorted({s // tile for s, _ in runs})
        return torch.tensor((hot + [t for t in range(N_KERNEL // tile)
                                    if t not in hot])[:32],
                            dtype=torch.int32, device=dev)

    # (tile, batches): the search path's tile at every batch, and the
    # reference benchmark's tile 4096 at its batch of 1024.
    shapes = ((TILE, (1, 64, 1024)), (BENCH_TILE, (1024,)))
    for dtype in (torch.float32, torch.bfloat16):
        corpus = corpus32.to(dtype)
        for tile, batches in shapes:
            for b in batches:
                K_.reset_launch_counts()
                recs = hold_calls(K_, T_, dense_calls(
                    q_all[:b], corpus, size, tile, union(tile), 16,
                    floor=dtype == torch.bfloat16), reps=5,
                    where=f"kernels {dtype} B={b} tile={tile}")
                launches = K_.launch_counts()
                for name, rec in recs.items():
                    emit({"phase": "kernels", "kernel": name,
                          "dtype": str(dtype).removeprefix("torch."),
                          "launches": launches[name], **rec})
        del corpus
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    c8, cs = quantize_int8(corpus32)
    for tile, batches in shapes:
        for b in batches:
            K_.reset_launch_counts()
            recs = hold_calls(K_, T_, int8_calls(
                q_all[:b], c8, cs, size, tile, union(tile), CC_SERVED,
                scaled=True), reps=5, where=f"kernels int8 B={b} tile={tile}")
            launches = K_.launch_counts()
            for name, rec in recs.items():
                emit({"phase": "kernels", "kernel": name, "dtype": "int8",
                      "launches": launches[name], **rec})
    del corpus32, centers, q_all, c8, cs
    # The scan's tensor-core sums against the bound its certificate rests
    # on (csrc/scan_mma.cuh), on operands that press on it: K1's main loop
    # over bf16 rows, and K2's over int8 codes (the raw sums, and the
    # scaled scores at mixed row scales).
    from optimized_rag_tpu_torch.ops import scan_rounding as R
    for rows in ("bf16", "int8"):
        for d, mode in ((128, "full"), (DIM, "full"), (DIM, "split")):
            if rows == "bf16":
                q, c = R.operands(SEED + d, 1024, 16384, d, torch.bfloat16,
                                  dev)
                scales = (None,)
            else:
                q, c, cs = R.code_operands(SEED + d, 1024, 16384, d, dev)
                scales = (None, cs)
            sums = K_.scan_sums(q, c, BENCH_TILE, split=mode == "split")
            for cs in scales:
                ratio = R.rounding_ratio(q, c, sums, mode, row_scale=cs)
                emit({"phase": "kernels", "check": "scan_rounding",
                      "rows": rows, "scaled": cs is not None, "d": d,
                      "mode": mode, "ratio_to_bound": ratio})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"scan rounding over {rows} rows at D={d} ({mode}, "
                        f"scaled {cs is not None}): {ratio:.3g} of its "
                        "bound")
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})


def fill_index(index, svc, chunks, dev, n_rows=N_BIG, on_block=None):
    """qa_docs chunk embeddings, then clustered synthetic rows with runs of
    near-duplicates (of chunks and of synthetic rows) up to ``n_rows``
    rows, generated on the card in 2**20-row blocks; ``on_block(x, start)``
    sees each block just after it is added at row ``start``."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = random.Random(SEED)
    chunk_emb = torch.from_numpy(svc.encode(chunks)).to(dev)
    index.add(chunk_emb)
    if on_block:
        on_block(chunk_emb, 0)
    centers = torch.randn(4096, DIM, generator=gen, device=dev) * 2.0
    runs = plan_runs(rng, n_rows, len(chunks), 300)
    bases = {start: (chunk_emb[j % len(chunks)] if j < 2 * len(chunks)
                     else None)
             for j, (start, _) in enumerate(rng.sample(runs, len(runs)))}
    block = 1 << 20
    for lo in range(0, n_rows, block):
        lo_, hi = max(lo, index.size), min(n_rows, lo + block)
        x = clustered_rows(hi - lo_, gen, centers)
        for start, length in runs:
            if lo_ <= start < hi:
                base = bases[start]
                base = x[start - lo_] if base is None else base
                x[start - lo_:start - lo_ + length] = near_duplicates(
                    base, length, gen)
        index.add(x)
        if on_block:
            on_block(x, lo_)
        del x
    assert index.size == n_rows
    return runs


def drive_server(QueryServer, svc, index, queries, burst):
    """8 clients, each submitting its queries ``burst`` at a time and
    waiting on every future before the next burst (burst=1: closed loop,
    at most 8 queries in flight; burst=8: up to 64). Returns answers,
    per-request latencies (s), wall seconds and the server's stats."""
    server = QueryServer(svc.encode, index, max_batch=64, workers=2)
    answers, lat = [None] * len(queries), [0.0] * len(queries)
    errors = []

    def client(c):
        try:
            mine = list(range(c, len(queries), N_CLIENTS))
            for j in range(0, len(mine), burst):
                sent = [(i, time.perf_counter(), server.submit(queries[i], K))
                        for i in mine[j:j + burst]]
                for i, t_sub, fut in sent:
                    answers[i] = fut.result(timeout=120)
                    lat[i] = time.perf_counter() - t_sub
        except BaseException as exc:          # reported by the main thread
            errors.append(exc)

    server.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    alive = [t for t in clients + server._threads if t.is_alive()]
    if errors:
        raise errors[0]
    if alive:
        raise RuntimeError(f"{len(alive)} threads still alive after stop()")
    return answers, lat, wall, server.get_stats()


def counted(K_, paths, name, fn):
    """``fn()`` with every launch count set to 0 just before it; the counts
    read just after go into ``paths[name]``."""
    K_.reset_launch_counts()
    out = fn()
    paths[name] = K_.launch_counts()
    return out


def certified_alone(T_, q, corpus, size, k, scan_dtype):
    """Each query alone through the certified search, so its certificate is
    its own: every answer the certificate passes must equal the chunked
    exact oracle's. Returns how many queries certified."""
    o_s, o_i = oracle_topk(q, corpus, size, k, scan_dtype=scan_dtype)
    certified = 0
    for j in range(q.shape[0]):
        s, packed = T_.topk_certified(q[j:j + 1], corpus, k, size, tile=TILE)
        if T_.certificate_uncovered(packed) == 0:
            check_answers(f"certified answer {j} ({corpus.dtype})",
                          packed[:-1], s, o_i[j:j + 1], o_s[j:j + 1])
            certified += 1
    if not certified:
        raise AssertionError(f"no query certified alone ({corpus.dtype}): "
                             "no certified answer was held")
    return certified


def require_launched(paths, user_paths, names, what):
    """Every kernel of ``names`` launched at least once on the paths a user
    drives."""
    for name in names:
        if not sum(paths[p][name] for p in user_paths):
            raise AssertionError(f"{name} never launched on the {what} path")


def phase_slice_f32(K_, T_, dev, chunks, queries):
    """``queries``: two disjoint lists of N_QUERIES texts, one per round.
    Launch counts are read per path: the two served rounds, the
    131,072-row index (the user's paths), and the checks that call the
    top-k functions directly."""
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.models.convert import load_biencoder
    from optimized_rag_tpu_torch.serving import QueryServer
    t0 = time.perf_counter()
    svc = load_biencoder(os.path.join(HERE, "checkpoints", "pretrained"),
                         device=dev)
    cfg = svc.cfg
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    runs = fill_index(index, svc, chunks, dev)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0

    # Warm-up: one request through the encoder and the index.
    index.search(svc.encode(["warm-up request"]), K)
    emb = index.embeddings()

    # The main path: QueryServer rounds, each counted on its own.
    paths, rounds = {}, {}
    for name, burst, texts in (("served_burst", 8, queries[0]),
                               ("served_closed_loop", 1, queries[1])):
        answers, lat, wall, stats = counted(
            K_, paths, name,
            lambda: drive_server(QueryServer, svc, index, texts, burst))
        q = unit(torch.from_numpy(svc.encode(texts)).to(dev))
        o_s, o_i = oracle_topk(q, emb, index.size, K)
        got_s = torch.tensor(np.stack([a[0] for a in answers]), device=dev)
        got_i = torch.tensor(np.stack([a[1] for a in answers]), device=dev)
        err = check_answers(f"served answers ({name})", got_i, got_s, o_i,
                            o_s)
        lat_ms = sorted(x * 1e3 for x in lat)
        rounds[name] = {
            "queries": len(texts), "clients": N_CLIENTS, "burst": burst,
            "qps": len(texts) / wall, "p50_ms": statistics.median(lat_ms),
            "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
            "batches": stats["batches"], "avg_batch": stats["avg_batch"],
            "launches": paths[name],
            "launches_per_batch": {k: v / stats["batches"]
                                   for k, v in paths[name].items()},
            "oracle_max_err": err}

    # A 131,072-row index routes straight to the tiled kernel search.
    qb = q[:64]
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    small.add(emb[:N_SMALL])
    res = counted(K_, paths, "small_index", lambda: small.search(qb, K))
    if paths["small_index"] != {**dict.fromkeys(K_.KERNELS, 0),
                                "tile_topk": 1}:
        raise AssertionError(f"small index did not route to K6 alone: "
                             f"{paths['small_index']}")
    os_, oi_ = oracle_topk(qb, small.embeddings(), small.size, K)
    check_answers("small index", torch.from_numpy(res.ids).to(dev),
                  torch.from_numpy(res.scores).to(dev), oi_, os_)
    require_launched(paths, USER_PATHS_F32, FLOAT_KERNELS + ("extract_pairs",),
                     "f32")

    # Certified answers held one query at a time (served batches mostly
    # fall back, so few certified answers reach the oracle above).
    kk = K_SERVED
    n_cert = counted(K_, paths, "certified_alone", lambda: certified_alone(
        T_, q[:64], emb, index.size, kk, torch.float32))

    # Forced fallback: one union slot cannot cover the batch, so the
    # deferred certificate reads nonzero and DenseIndex's settle step
    # repairs the pairs the covers left (K4p); with a cover that names every
    # pair it reruns the exact tiled search (K6) instead.
    s_c, packed, _, cover = T_._packed_search(
        qb, emb, kk, index.size, TILE, GROUPS, 1, None, None, True,
        covers=True)
    every = T_.Cover(torch.ones_like(cover.need), cover.mode)
    of_s, of_i = oracle_topk(qb, emb, index.size, kk)
    for name, cov, k6 in (("forced_fallback", every, 1),
                          ("forced_repair", cover, 0)):
        f_s, f_i, route, uncovered = counted(
            K_, paths, name, lambda: index._settle_certificate(
                qb, s_c, packed, kk, cov))
        if uncovered == 0 or route != "fallback":
            raise AssertionError("union_tiles=1 certified every query: the "
                                 "forced fallback did not trigger")
        launched = (paths[name]["tile_topk"], paths[name]["extract_pairs"])
        if launched != (k6, 1 - k6):
            raise AssertionError(f"{name}: {launched} K6 and K4p launches")
        check_answers(name.replace("_", " "), f_i, f_s, of_i, of_s)
    d_s, d_i = counted(K_, paths, "dispatch_topk", lambda: T_.dispatch_topk(
        qb, emb, kk, index.size, tile=TILE))
    check_answers("dispatch_topk", d_i, d_s, of_i, of_s)

    # Where a served batch's time goes: each layer alone, host clock
    # around synchronised work, median of 3 (fresh texts: cache misses).
    layers = {}
    for b in (64, 8):
        for r in range(4):
            t1 = time.perf_counter()
            qv = svc.encode([f"{t} ({b}/{r})" for t in queries[0][:b]])
            t2 = time.perf_counter()
            index.search(qv, kk)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:                         # the first is a warm-up
                layers.setdefault(f"encode_b{b}_ms", []).append(
                    (t2 - t1) * 1e3)
                layers.setdefault(f"search_b{b}_ms", []).append(
                    (t3 - t2) * 1e3)
    layers = {k: statistics.median(v) for k, v in layers.items()}

    # Each kernel against its twin at the search path's shapes.
    sel_tiles = torch.tensor(sorted({s // TILE for s, _ in runs})[:32],
                             dtype=torch.int32, device=dev)
    recs = hold_calls(K_, T_, dense_calls(qb, emb, index.size, TILE,
                                          sel_tiles, kk)
                      + [pairs_call(T_, qb, emb, index.size, TILE, kk)], 3,
                      "slice_f32")
    emit({"phase": "slice_f32", "rows": index.size, "dim": DIM,
          "encoder": {"layers": cfg.num_layers, "hidden": cfg.hidden_dim,
                      "heads": cfg.num_heads, "vocab": cfg.vocab_size,
                      "max_len": svc.max_len},
          "chunks": len(chunks), "runs": len(runs), **rounds,
          "launches_by_path": paths, "certified_alone": n_cert,
          "layers": layers, "forced_uncovered": uncovered,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    del small, res, qb, q, emb
    torch.cuda.empty_cache()
    return svc, index, paths, recs, sel_tiles


def phase_slice_bf16(K_, T_, dev, svc, index32, queries, sel_tiles):
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    t0 = time.perf_counter()
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.bfloat16, device=dev)
    emb32 = index32.embeddings()
    for lo in range(0, index32.size, 1 << 20):
        index.add(emb32[lo:min(index32.size, lo + (1 << 20))])
    del emb32
    torch.cuda.empty_cache()
    q = unit(torch.from_numpy(svc.encode(queries[0][:64])).to(dev))
    emb = index.embeddings()

    paths = {}
    res = counted(K_, paths, "search", lambda: index.search(q, K))
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.bfloat16, device=dev)
    small.add(emb[:N_SMALL])
    res_small = counted(K_, paths, "small_index", lambda: small.search(q, K))
    require_launched(paths, USER_PATHS_BF16, FLOAT_KERNELS, "bf16")

    for idx, r in ((index, res), (small, res_small)):
        # The plain pipeline: bf16 scan, top-40, f32 rescore, top-10.
        _, cand = oracle_topk(q, idx.embeddings(), idx.size, 4 * K,
                              scan_dtype=torch.bfloat16)
        cand = cand.sort(dim=1).values       # exact ties to the lower row
        rows = idx.embeddings()[cand].float()
        s = (rows * q[:, None, :]).sum(-1)
        s, pos = torch.sort(s, dim=1, descending=True, stable=True)
        want_s, want_i = s[:, :K], torch.gather(cand, 1, pos[:, :K])
        check_answers(f"bf16 index of {idx.size} rows",
                      torch.from_numpy(r.ids).to(dev),
                      torch.from_numpy(r.scores).to(dev), want_i, want_s)
    # The bf16 scan's certified answers (k = 4 x 10, as search asks), one
    # query at a time, against the bf16-scan oracle.
    n_cert = counted(K_, paths, "certified_alone", lambda: certified_alone(
        T_, q, emb, index.size, 4 * K, torch.bfloat16))
    recs = hold_calls(K_, T_, dense_calls(q, emb, index.size, TILE,
                                          sel_tiles, 4 * K), 3, "slice_bf16")
    emit({"phase": "slice_bf16", "rows": index.size,
          "gbytes": index.size * DIM * 2 / 1e9, "B": q.shape[0],
          "launches_by_path": paths, "certified_alone": n_cert,
          "seconds": time.perf_counter() - t0})
    del index, small, emb, q
    torch.cuda.empty_cache()
    return paths, recs


class RouteLog:
    """The index as QueryServer sees it, recording each batch it searches:
    the query rows as the server passed them and the route they took."""

    def __init__(self, index):
        self.index = index
        self.batches = []
        self._lock = threading.Lock()

    def search(self, q, k):
        res = self.index.search(q, k)
        with self._lock:
            self.batches.append((np.array(q, dtype=np.float32), res.route))
        return res


def phase_slice_int8(K_, T_, dev, svc, chunks, queries):
    """int8 storage on the served path: 16,777,216 rows (4x the f32 slice's
    rows in the same bytes). Every answer is held against the oracle of the
    route its batch took; recall@10 against the f32 oracle of the
    unquantized rows is printed, not gated."""
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    from optimized_rag_tpu_torch.ops.similarity import normalize
    from optimized_rag_tpu_torch.serving import QueryServer
    t0 = time.perf_counter()
    texts = queries[0] + queries[1]
    with svc._cache_lock:                 # fresh encodes, as in slice_f32
        svc._cache.clear()
    q32 = unit(torch.from_numpy(svc.encode(texts)).to(dev))
    f32 = {"s": torch.full((len(texts), K), float("-inf"), device=dev),
           "i": torch.full((len(texts), K), -1, dtype=torch.long,
                           device=dev), "rows": 0}
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.int8, device=dev)

    def on_block(x, start):
        # add stored exactly quantize_int8(normalize(rows)), and, in the
        # blocks of cpu_blocks, quantize_int8 on the card equals its CPU
        # result bit for bit.
        u = normalize(x.float())
        c8, cs = quantize_int8(u)
        if start in cpu_blocks:
            h8, hs = quantize_int8(u.cpu())
            if not (torch.equal(c8.cpu(), h8)
                    and torch.equal(cs.cpu().view(torch.int32),
                                    hs.view(torch.int32))):
                raise AssertionError(f"quantize_int8 on the card differs "
                                     f"from the CPU's in rows {start}..")
            cpu_blocks.discard(start)
        n = x.shape[0]
        if not (torch.equal(index.embeddings()[start:start + n], c8)
                and torch.equal(index.row_scale[start:start + n], cs)):
            raise AssertionError(f"DenseIndex.add stored other codes than "
                                 f"quantize_int8(normalize(rows)) at {start}")
        # The f32 oracle of the unquantized rows, for recall.
        cand_s = torch.cat([f32["s"], q32 @ u.T], dim=1)
        cand_i = torch.cat([f32["i"], torch.arange(
            start, start + n, device=dev).expand(len(texts), -1)], dim=1)
        f32["s"], pos = torch.topk(cand_s, K, dim=1)
        f32["i"] = torch.gather(cand_i, 1, pos)
        f32["rows"] += n

    # The blocks held against the CPU (by first row): the chunks', the
    # first synthetic block (the rest of fill_index's first 2**20 rows)
    # and the last.
    cpu_blocks = {0, len(chunks), (N_INT8 - 1) >> 20 << 20}
    runs = fill_index(index, svc, chunks, dev, N_INT8, on_block)
    torch.cuda.synchronize()
    if cpu_blocks:
        raise AssertionError(f"slice_int8: blocks {sorted(cpu_blocks)} "
                             "were never checked against the CPU")
    t_fill = time.perf_counter() - t0
    with svc._cache_lock:
        svc._cache.clear()
    index.search(svc.encode(["warm-up request"]), K)
    emb, scale = index.embeddings(), index.row_scale

    paths, rounds, logs = {}, {}, {}
    for name, burst, texts_r in (("served_burst", 8, queries[0]),
                                 ("served_closed_loop", 1, queries[1])):
        log = RouteLog(index)
        answers, lat, wall, stats = counted(
            K_, paths, name,
            lambda: drive_server(QueryServer, svc, log, texts_r, burst))
        lat_ms = sorted(x * 1e3 for x in lat)
        routes = [r for _, r in log.batches]
        rounds[name] = {
            "queries": len(texts_r), "clients": N_CLIENTS, "burst": burst,
            "qps": len(texts_r) / wall, "p50_ms": statistics.median(lat_ms),
            "p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
            "batches": stats["batches"], "avg_batch": stats["avg_batch"],
            "routes": {r: routes.count(r) for r in sorted(set(routes))},
            "launches": paths[name],
            "launches_per_batch": {k: v / stats["batches"]
                                   for k, v in paths[name].items()}}
        logs[name] = (log, answers, texts_r)

    # Direct DenseIndex.search of 64 queries, and a 131,072-row int8 index
    # (128 tiles < 64 * 40: the tiled K7 search alone).
    q64_raw = svc.encode(queries[0][:64])
    res64 = counted(K_, paths, "search", lambda: index.search(q64_raw, K))
    small = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.int8, device=dev)
    small.add(index.vectors_f32(N_SMALL))
    res_small = counted(K_, paths, "small_index",
                        lambda: small.search(q64_raw, K))
    if paths["small_index"] != {**dict.fromkeys(K_.KERNELS, 0),
                                "tile_topk_scaled": 1}:
        raise AssertionError(f"small int8 index did not route to K7 alone: "
                             f"{paths['small_index']}")
    require_launched(paths, USER_PATHS_INT8, INT8_KERNELS, "int8")

    # Every answer against the oracle of its route. The queries as the
    # index normalised them: each batch as it was searched.
    batches = [(name, qraw, route) for name, (log, _, _) in logs.items()
               for qraw, route in log.batches]
    batches.append(("search", q64_raw, res64.route))
    qn = [normalize(torch.from_numpy(qraw).to(dev).float())
          for _, qraw, _ in batches]
    qn_all = torch.cat(qn)
    h8, hs = quantize_int8(qn_all.cpu())
    q8, qs = quantize_int8(qn_all)
    if not (torch.equal(q8.cpu(), h8)
            and torch.equal(qs.cpu().view(torch.int32), hs.view(torch.int32))):
        raise AssertionError("quantize_int8 of the queries differs between "
                             "the card and the CPU")
    oracle = int8_oracle(qn_all, emb, scale, index.size, CC_SERVED + 1)
    held = {"certified": 0, "fallback": 0, "direct": 0}
    boundary = []
    lo = 0
    answers_by_row = {}          # query row's bytes -> its answers
    for name, (log, answers, texts_r) in logs.items():
        emb_r = svc.encode(texts_r)               # cache hits: same bytes
        for i, a in enumerate(answers):
            answers_by_row.setdefault(emb_r[i].tobytes(), []).append(a)
    for (name, qraw, route), qb in zip(batches, qn):
        m = qb.shape[0]
        orc = {r: (v[0][lo:lo + m], v[1][lo:lo + m])
               for r, v in oracle.items()}
        lo += m
        if name == "search":
            got_i = torch.from_numpy(res64.ids).to(dev)
            got_s = torch.from_numpy(res64.scores).to(dev)
            n_b = hold_route("int8 search of 64", route, got_i, got_s, orc,
                             qb, emb, scale, 4 * K, K)
            held[route] += m
        else:
            rows, got_i, got_s = [], [], []
            for r in range(m):
                # Pad rows repeat a query: its answers are taken once.
                for a in answers_by_row.pop(qraw[r].tobytes(), []):
                    rows.append(r)
                    got_s.append(a[0])
                    got_i.append(a[1])
            rows = torch.tensor(rows, device=dev)
            orc = {r: (v[0][rows], v[1][rows]) for r, v in orc.items()}
            n_b = hold_route(
                f"served int8 answers ({name})", route,
                torch.tensor(np.stack(got_i), device=dev),
                torch.tensor(np.stack(got_s), device=dev), orc, qb[rows],
                emb, scale, CC_SERVED, K_SERVED)
            held[route] += len(rows)
        if n_b:
            boundary.append({"batch": name, "route": route, "answers": n_b})
    if answers_by_row:
        raise AssertionError(f"{len(answers_by_row)} served answers were not "
                             "found in any searched batch")
    q_small = normalize(torch.from_numpy(q64_raw).to(dev).float())
    orc_small = int8_oracle(q_small, small.embeddings(), small.row_scale,
                            small.size, 4 * K + 1)
    n_small = hold_route("small int8 index", res_small.route,
                         torch.from_numpy(res_small.ids).to(dev),
                         torch.from_numpy(res_small.scores).to(dev),
                         orc_small, q_small, small.embeddings(),
                         small.row_scale, 4 * K, K)
    if n_small:
        boundary.append({"batch": "small_index", "route": res_small.route,
                         "answers": n_small})

    # Recall@10 of the served answers against the f32 oracle of the
    # unquantized rows (a quality reading, not a gate).
    recall = {}
    for j, (name, (_, answers, _)) in enumerate(logs.items()):
        hits = [len(set(a[1][:K].tolist())
                    & set(f32["i"][j * N_QUERIES + i].tolist()))
                for i, a in enumerate(answers)]
        recall[name] = sum(hits) / (K * len(hits))

    # 64 queries alone through the certified int8 search: each answer
    # whose certificate reads 0 must equal the exact int8-native oracle.
    q64 = qn[-1]
    m = q64.shape[0]
    o_s, o_i = oracle["certified"][0][-m:], oracle["certified"][1][-m:]

    def alone():
        certs = []
        for j in range(m):
            s_c, packed = T_.topk_certified(q64[j:j + 1], emb, CC_SERVED,
                                            index.size, tile=TILE,
                                            row_scale=scale)
            certs.append(T_.certificate_uncovered(packed))
            if certs[-1] == 0:
                if not (torch.equal(packed[:-1], o_i[j:j + 1, :CC_SERVED])
                        and torch.equal(s_c, o_s[j:j + 1, :CC_SERVED])):
                    check_answers(f"certified int8 answer {j}", packed[:-1],
                                  s_c, o_i[j:j + 1, :CC_SERVED],
                                  o_s[j:j + 1, :CC_SERVED], tol=0.0)
                    raise AssertionError(f"certified int8 answer {j}: scores "
                                         "not bit-equal to the oracle's")
        return certs
    certs = counted(K_, paths, "certified_alone", alone)
    if not certs.count(0):
        raise AssertionError("no int8 query certified alone")

    layers = {}
    for b in (64, 8):
        for r in range(4):
            t1 = time.perf_counter()
            qv = svc.encode([f"{t} (int8 {b}/{r})" for t in queries[0][:b]])
            t2 = time.perf_counter()
            index.search(qv, K_SERVED)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if r:
                layers.setdefault(f"encode_b{b}_ms", []).append(
                    (t2 - t1) * 1e3)
                layers.setdefault(f"search_b{b}_ms", []).append(
                    (t3 - t2) * 1e3)
    layers = {k: statistics.median(v) for k, v in layers.items()}

    sel_tiles = torch.tensor(sorted({s // TILE for s, _ in runs})[:32],
                             dtype=torch.int32, device=dev)
    recs = hold_calls(K_, T_, int8_calls(q64, emb, scale, index.size, TILE,
                                         sel_tiles, CC_SERVED), 3,
                      "slice_int8")
    emit({"phase": "slice_int8", "rows": index.size, "dim": DIM,
          "code_gbytes": index.size * DIM / 1e9,
          "scale_mbytes": index.size * 4 / 1e6, "runs": len(runs),
          "quantize_rows_checked": f32["rows"],
          "quantize_queries_checked": qn_all.shape[0], **rounds,
          "answers_held": held, "boundary_differences": boundary,
          "recall_at_10_vs_f32": recall,
          "certificates_alone": certs, "certified_alone": certs.count(0),
          "launches_by_path": paths, "layers": layers,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    del index, small, emb, scale, oracle, orc_small
    torch.cuda.empty_cache()
    return paths, recs


@contextlib.contextmanager
def with_twin_scan(T_, K_):
    """ops/topk.py with K1 replaced by its plain twin, on the card: the
    same pipeline without the scan kernel."""
    kernel = T_.packed_extract
    T_.packed_extract = lambda q, c, size, tile, groups=8, flag=None: \
        K_.packed_extract_plain(K_._scan_queries(q, c), c, size, tile, groups)
    try:
        yield
    finally:
        T_.packed_extract = kernel


@contextlib.contextmanager
def recording(T_, K_, log):
    """Each kernel wrapper that ops/topk.py calls (and ``K_.scan_floor``)
    appends (name, args) to ``log`` and launches as before."""
    saved = [(mod, name, getattr(mod, name)) for mod in (T_, K_)
             for name in K_.KERNELS if name in vars(mod)]

    def spy(name, fn):
        def call(*args):
            log.append((name, args))
            return fn(*args)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, spy(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int8: "int8"}


def call_shape(name, args):
    """What a kernel's time depends on: (dtype, B, N, D, tile, m, U)."""
    q, corpus, _, _, tile, m, tiles, _ = call_operands(name, args)
    return (DTYPE_NAMES[corpus.dtype], q.shape[0], *corpus.shape, tile, m,
            None if tiles is None else tiles.shape[0])


def shape_label(name, rec):
    """``B=.. tile=..`` and what m is: groups (scans), rounds over U tiles
    (covers) or tile_k."""
    m = ("" if name == "scan_floor"
         else f" groups={rec['m']}" if name.startswith("packed")
         else f" rounds={rec['m']} P={rec['U']}" if name == "extract_pairs"
         else f" rounds={rec['m']} U={rec['U']}" if name.startswith("extract")
         else f" tile_k={rec['m']}")
    return f"B={rec['B']} tile={rec['tile']}{m}"


def hold_recorded(K_, T_, log, reps, where):
    """Hold one call of each distinct (kernel, shape) in ``log`` (path ->
    the (name, args) its run recorded) against its twin; each record
    carries how many launches of that shape every path made."""
    shapes = {}
    for path, calls in log.items():
        for name, args in calls:
            e = shapes.setdefault((name, *call_shape(name, args)),
                                  {"args": args, "by_path": {}})
            e["by_path"][path] = e["by_path"].get(path, 0) + 1
    out = []
    for key, e in shapes.items():
        name, dtype, b, _, _, tile, m, _ = key
        rec = hold_call(K_, T_, name, e.pop("args"), reps,
                        f"{where} {name} B={b} tile={tile} m={m}",
                        plain_reps=1)
        rec["shape"] = shape_label(name, rec)
        rec["fma_floor_ms"] = rec["flops"] / PEAK_F32 * 1e3
        out.append({"name": name, "dtype": dtype, "launches_by_path":
                    e["by_path"], **rec})
    log.clear()
    return out


def phase_bench_shape(K_, T_, dev):
    """The reference benchmark's retrieval path at its full shape
    (bench.py:180-265 and :540-575): 10,485,760 x 128 bf16 rows (the
    generator of benchmarks/common.py with 4,096 clusters, plus 300
    near-duplicate runs), tile 4096, k 10, unit-normal queries from a seed
    in batches of 1024 and 512. Every certified or verified answer with a
    certificate of 0 equals its route's oracle, and every other is rerun
    exactly and equals it too; ANN answers equal the same pipeline run with
    the scan's twin on the card, except for queries with a boundary word.
    Every kernel call the routes make is recorded; one call of each
    distinct shape is held against its twin and timed. Returns the
    launches of each path and those records, bf16 and int8 apart."""
    from optimized_rag_tpu_torch.ops.quantize import quantize_int8
    t0 = time.perf_counter()
    n, d, tile, k = N_BENCH, DIM_BENCH, BENCH_TILE, K
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    centers = torch.randn(4096, d, generator=gen, device=dev) * 2.0
    runs = plan_runs(random.Random(SEED + 2), n, 0, 300)
    corpus = torch.empty((n, d), dtype=torch.bfloat16, device=dev)
    block = 1 << 20
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        x = clustered_rows(hi - lo, gen, centers)
        for start, length in runs:             # 32-aligned: inside a block
            if lo <= start < hi:
                x[start - lo:start - lo + length] = near_duplicates(
                    x[start - lo], length, gen)
        corpus[lo:hi] = x.to(torch.bfloat16)
        del x
    del centers
    rng = np.random.default_rng(SEED)        # bench.py:195-203

    def qbatch(b):
        x = rng.standard_normal((b, d)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x).to(dev)
    q_head, q_cmp, q_batch = qbatch(B_HEAD), qbatch(B_CMP), qbatch(B_BATCH)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    oracle = {B_HEAD: oracle_topk(q_head, corpus, n, k, torch.bfloat16),
              B_CMP: oracle_topk(q_cmp, corpus, n, k, torch.bfloat16)}
    paths, routes, log = {}, {}, {}

    def run(name, fn):
        """``fn()`` counted as path ``name``, its kernel calls recorded;
        the recorded calls must be exactly the counted launches."""
        calls = log.setdefault(name, [])
        with recording(T_, K_, calls):
            out = counted(K_, paths, name, fn)
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if seen != paths[name]:
            raise AssertionError(f"bench_shape {name}: recorded {seen}, "
                                 f"counted {paths[name]}")
        return out

    def route(name, q, call, rerun, want, want_rerun=None, tol=TIE_TOL):
        """``call()`` -> (scores, ids with the certificate row), counted as
        path ``name`` together with the exact ``rerun()`` where the
        certificate is not 0; the answer held against its oracle (``want``,
        or ``want_rerun`` for a rerun answer); then ``call`` timed alone,
        and where the certificate was not 0 the rerun too (``rerun_ms``;
        ``path_ms`` is the two together)."""
        def path():
            s, packed = call()
            uncovered = T_.certificate_uncovered(packed)
            if uncovered:
                s, ids = rerun()
                return uncovered, s, ids
            return uncovered, s, packed[:-1]
        uncovered, s, ids = run(name, path)
        o_s, o_i = want_rerun if uncovered and want_rerun else want
        check_answers(f"bench_shape {name}", ids, s, o_i, o_s,
                      tol=TIE_TOL if uncovered else tol)
        ms = median_ms(call, 3)
        routes[name] = {"B": q.shape[0], "uncovered": uncovered,
                        "route": "fallback" if uncovered else "certified",
                        "ms": ms, "qps": q.shape[0] / ms * 1e3}
        if uncovered:          # what the failed certificate costs on top
            rerun_ms = median_ms(rerun, 3)
            routes[name].update(rerun_ms=rerun_ms, path_ms=ms + rerun_ms,
                                path_qps=q.shape[0] / (ms + rerun_ms) * 1e3)

    # 1. Certified at tile 4096, groups 8 (K1 -> K4; K6 on a nonzero
    # certificate), b1024, b512 and two sub-batches of 512.
    for name, q, call in (
            ("certified_b1024", q_head, lambda: T_.topk_certified(
                q_head, corpus, k, tile=tile, groups=GROUPS)),
            ("certified_b512", q_cmp, lambda: T_.topk_certified(
                q_cmp, corpus, k, tile=tile, groups=GROUPS)),
            ("certified_multi_2x512", q_head, lambda: T_.topk_certified_multi(
                q_head, corpus, k, sub_batch=B_CMP, tile=tile,
                groups=GROUPS))):
        route(name, q, call, lambda q=q: T_.tiled_topk(q, corpus, k,
                                                       tile=tile),
              oracle[q.shape[0]])

    # 1b. The batch cell's scan: dispatch_topk settles a nonzero
    # certificate by K4p on the pairs the covers left (no K6); the answer
    # against the oracle up to near-tie swaps (c1's cuBLAS sums against
    # K4p's FMA chain).
    batch = lambda: T_.dispatch_topk(q_batch, corpus, K_BATCH, tile=tile)
    b_s, b_i = run("dispatch_b4096", batch)
    o_s, o_i = oracle_topk(q_batch, corpus, n, K_BATCH, torch.bfloat16,
                           chunk=65_536)
    _, swaps = check_selection(
        "bench_shape dispatch_b4096", K_._scan_queries(q_batch, corpus),
        corpus, b_i.T[None], b_s.T[None], o_i.T[None], o_s.T[None])
    if paths["dispatch_b4096"]["extract_pairs"] != 1 or \
            paths["dispatch_b4096"]["tile_topk"]:
        raise AssertionError("bench_shape dispatch_b4096: "
                             f"{paths['dispatch_b4096']}, not one K4p "
                             "launch and no K6")
    ms = median_ms(batch, 3)
    routes["dispatch_b4096"] = {"B": B_BATCH, "k": K_BATCH,
                                "near_tie_swaps": swaps, "ms": ms,
                                "qps": B_BATCH / ms * 1e3}
    del b_s, b_i, o_s, o_i

    # 2. ANN at oversample 32, b1024, against the same pipeline with the
    # scan's twin; K1's words held as in the kernel phase.
    ann = lambda: T_.topk_ann(q_head, corpus, k, tile=tile, groups=GROUPS,
                              oversample=32)
    a_s, a_i = run("ann_b1024", ann)
    with with_twin_scan(T_, K_):
        p_s, p_i = ann()
    qs = K_._scan_queries(q_head, corpus)
    w = K_.packed_extract(q_head, corpus, None, tile, GROUPS)
    w_p = K_.packed_extract_plain(qs, corpus, None, tile, GROUPS)
    faults, boundary = K_.packed_word_faults(qs, corpus, None, tile, w, w_p,
                                             drift=TIE_TOL, groups=GROUPS)
    on_boundary = (w != w_p).any(dim=1).any(dim=0)          # [B]
    del w, w_p
    differ = (a_i != p_i).any(dim=1) | (a_s != p_s).any(dim=1)
    if faults or bool((differ & ~on_boundary).any()):
        raise AssertionError(
            f"bench_shape ANN: {faults} faulty words; "
            f"{int((differ & ~on_boundary).sum())} answers differ from the "
            "twin pipeline's with no boundary word to explain them")
    recall = float(np.mean([
        len(set(a.tolist()) & set(o.tolist())) / k
        for a, o in zip(a_i.cpu(), oracle[B_HEAD][1].cpu())]))
    ms = median_ms(ann, 3)
    routes["ann_b1024"] = {
        "B": B_HEAD, "ms": ms, "qps": B_HEAD / ms * 1e3,
        "recall_at_10_vs_exact": recall,
        "answers_differing_from_twin_pipeline": int(differ.sum()),
        "queries_with_boundary_words": int(on_boundary.sum()),
        "boundary_words": boundary}

    # 3. Verified: per-query rescan at tile 1024, batch union at tile 4096.
    v_s, v_i = run("verified_b512", lambda: T_.topk_verified(
        q_cmp, corpus, k, tile=1024, tile_k=2))
    check_answers("bench_shape verified_b512", v_i, v_s, oracle[B_CMP][1],
                  oracle[B_CMP][0])
    ms = median_ms(lambda: T_.topk_verified(q_cmp, corpus, k, tile=1024,
                                            tile_k=2), 3)
    routes["verified_b512"] = {"B": B_CMP, "tile": 1024, "ms": ms,
                               "qps": B_CMP / ms * 1e3}
    route("verified_batch_b512", q_cmp,
          lambda: T_.topk_verified_batch(q_cmp, corpus, k, tile=tile,
                                         tile_k=2, union_tiles=32),
          lambda: T_.tiled_topk(q_cmp, corpus, k, tile=tile), oracle[B_CMP])

    # 5 (before the int8 copy). F over the bf16 rows at b1024: each tile's
    # best score; the best of all equals the oracle's top score.
    f = run("floor_b1024", lambda: K_.scan_floor(q_head, corpus, tile))
    top_err = float((f.amax(dim=0)[0] - oracle[B_HEAD][0][:, 0]).abs().max())
    if not top_err <= TIE_TOL:
        raise AssertionError(f"bench_shape floor: {top_err:.3g} from the "
                             "oracle's best score")
    del f
    bf16_paths = tuple(log)
    require_launched(paths, bf16_paths,
                     FLOAT_KERNELS + ("scan_floor", "extract_pairs"),
                     "bench_shape bf16")
    held16 = hold_recorded(K_, T_, log, 3, "bench_shape bf16")

    # 4. The same rows as int8 codes, quantized on the card in blocks.
    c8 = torch.empty((n, d), dtype=torch.int8, device=dev)
    cs = torch.empty(n, device=dev)
    for lo in range(0, n, block):
        c8[lo:lo + block], cs[lo:lo + block] = quantize_int8(
            corpus[lo:lo + block].float())
    del corpus
    torch.cuda.empty_cache()
    q8, q8s = quantize_int8(q_head)
    q8f, qb = q8.float(), q_head.to(torch.bfloat16).float()
    native = running_topk(lambda lo, hi: ((q8f @ c8[lo:hi].float().T)
                                          * cs[lo:hi]) * q8s[:, None],
                          n, k, B_HEAD, dev)
    scaled = running_topk(lambda lo, hi: (qb @ c8[lo:hi].float().T)
                          * cs[lo:hi], n, k, B_HEAD, dev)
    fallback = lambda: T_.tiled_topk(q_head, c8, k, tile=tile, row_scale=cs)
    route("int8_native_b1024", q_head,
          lambda: T_.topk_certified_multi(
              q_head, c8, k, sub_batch=B_HEAD, tile=tile, groups=GROUPS,
              union_tiles=64, pad_r=26, row_scale=cs, int8_native=True),
          fallback, native, want_rerun=scaled, tol=0.0)
    route("int8_scaled_b1024", q_head,
          lambda: T_.topk_certified(q_head, c8, k, tile=tile, groups=GROUPS,
                                    row_scale=cs, int8_native=False),
          fallback, scaled)
    del q8, q8f, qb, native, scaled, oracle
    int8_paths = tuple(p for p in log)
    require_launched(paths, int8_paths, (
        "packed_extract_int8", "extract_int8", "packed_extract_scaled",
        "extract_scaled"), "bench_shape int8")
    held8 = hold_recorded(K_, T_, log, 3, "bench_shape int8")
    del c8, cs
    torch.cuda.empty_cache()

    emit({"phase": "bench_shape", "rows": n, "dim": d, "tile": tile,
          "k": k, "gbytes": n * d * 2 / 1e9,
          "int8_gbytes": n * (d + 4) / 1e9, "runs": len(runs),
          "routes": routes, "launches_by_path": paths,
          "fill_seconds": t_fill, "seconds": time.perf_counter() - t0})
    for rec in held16 + held8:
        emit({"phase": "bench_shape", "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return ({p: paths[p] for p in bf16_paths}, held16,
            {p: paths[p] for p in int8_paths}, held8)


# ---------------------------------------------------------- slice_hybrid

N_HYBRID = 262_144                # chunks of the hybrid slice (2**18)
FILLER_WORDS = 40                 # words of each seeded filler chunk
INGEST_BATCH = 128                # EmbeddingService.encode batch at ingest
N_HYBRID_QUERIES = 64
TOP_K, CANDIDATE_K, HALF_LIFE = 10, 50, 30.0
N_DELETED = 16                    # k = 50 + 16 stays within the kernels' 128
K_MMR, LAM = 5, 0.7
HYBRID_TOL = 1e-5                 # fused, semantic, BM25 (relative) scores
TEMPORAL_TOL = 1e-4               # now read in float32 days may step 2^-9
LOGIT_ATOL = 0.35                 # tests/test_torch_rerank.py, bf16 trunk
HYBRID_KERNEL_PATHS = ("dense_only_k2", "dense_only_k10", "tombstones")


def hybrid_corpus(chunks, n):
    """The qa_docs chunks, then seeded filler chunks of FILLER_WORDS words
    drawn from the chunks' own words, up to ``n``."""
    words = [w for c in chunks for w in c.split()]
    rng = random.Random(SEED + 3)
    return chunks + [" ".join(rng.choices(words, k=FILLER_WORDS))
                     for _ in range(n - len(chunks))]


def _top(scores, k):
    """Top-k of a float64 vector, ties to the lower index: (ids, scores).
    Candidates at or above the k-th value, in id order, then a stable
    sort."""
    k = min(k, scores.shape[0])
    kth = np.partition(scores, scores.shape[0] - k)[scores.shape[0] - k]
    cand = np.flatnonzero(scores >= kth)
    ids = cand[np.argsort(-scores[cand], kind="stable")[:k]]
    return ids, scores[ids]


class HybridOracle:
    """The hybrid query in float64 numpy, from the arrays LexicalIndex.build
    made (copied to the host), the index's rows and the query vectors the
    card computed: champion-list BM25, exact dense scores, the union of the
    two top-50 lists, min-max per channel over the union, the weighted blend
    and the top-k. The query's champion rows come from the index's host
    analyzer (``encode_query``); nothing computed on the card is reused."""

    def __init__(self, lexical, index, q_embs):
        d = lexical._device
        host = lambda t: t.cpu().numpy()
        self.lexical = lexical
        self.docs, self.valid = host(d["champ_docs"]), host(d["champ_valid"])
        self.tf = host(d["champ_tf"]).astype(np.float64)
        self.idf = host(d["idf"]).astype(np.float64)
        self.dlen = host(d["doc_len"]).astype(np.float64)
        self.avg = float(d["avg_len"])
        self.k1, self.b = lexical.k1, lexical.b
        self.size = index.size
        rows = index.embeddings()[:index.size].cpu().numpy().astype(
            np.float64)
        self.sem = rows @ np.asarray(q_embs, np.float64).T      # [N, Q]
        self.dead: list[int] = []

    def delete(self, rows):
        """Deleted rows are zeroed: they score 0 and leave the dense
        ranking."""
        self.dead = list(rows)
        self.sem[self.dead] = 0.0

    def bm25(self, text):
        q, v = self.lexical.encode_query(text)
        acc = np.zeros(self.size)
        for t in q[v]:                     # a document once per row
            m = self.valid[t]
            docs, tf = self.docs[t][m], self.tf[t][m]
            acc[docs] += self.idf[t] * tf * (self.k1 + 1.0) / (
                tf + self.k1 * (1.0 - self.b + self.b * self.dlen[docs]
                                / self.avg))
        return acc

    def dense(self, j):
        """(scores [N], the same with deleted rows at -inf) of query j."""
        sem = self.sem[:, j].copy()
        rank = sem.copy()
        rank[self.dead] = -np.inf
        return sem, rank

    def hybrid(self, j, text, ages_of, weights):
        """The fused top-k ids of query j, each union candidate's (fused,
        semantic, BM25, temporal) scores, and the gaps at the channels'
        50th candidates (dense absolute, BM25 relative)."""
        sem, rank = self.dense(j)
        d_ids, d_s = _top(rank, CANDIDATE_K + 1)
        b_ids, b_s = _top(self.bm25(text), CANDIDATE_K + 1)
        kw = {int(i): float(s) for i, s in zip(b_ids[:CANDIDATE_K],
                                                b_s[:CANDIDATE_K]) if s > 0}
        cand = np.array(sorted(set(d_ids[:CANDIDATE_K].tolist()) | set(kw)))
        chans = np.stack([sem[cand], [kw.get(int(c), 0.0) for c in cand],
                          np.exp2(-ages_of(cand) / HALF_LIFE)])
        lo, hi = chans.min(axis=1, keepdims=True), chans.max(
            axis=1, keepdims=True)
        normed = np.where(hi - lo < 1e-9, 0.5, (chans - lo) / np.maximum(
            hi - lo, 1e-9))
        w = np.asarray(weights, np.float64)
        fused = (normed * (w / w.sum())[:, None]).sum(axis=0)
        pos, _ = _top(fused, TOP_K)
        return {"ids": cand[pos].tolist(),
                "of": {int(c): (f, *ch) for c, f, ch in zip(
                    cand, fused, chans.T)},
                "dense_gap": float(d_s[CANDIDATE_K - 1] - d_s[CANDIDATE_K]),
                "bm25_gap": float((b_s[CANDIDATE_K - 1] - b_s[CANDIDATE_K])
                                  / max(b_s[CANDIDATE_K - 1], 1e-30))}


def hold_hybrid(what, docs, want, counts):
    """A route's answer against the oracle's: ids equal, and each doc's
    fused, semantic, BM25 (relative) and temporal scores within their
    tolerances of the oracle's for that doc. Differing ids are allowed
    only where the oracle shows a near-tie of HYBRID_TOL in the fused
    score, or at a channel's 50th candidate; such differences are counted.
    Returns the worst fused error."""
    ids, of = [d.doc_id for d in docs], want["of"]
    if ids != want["ids"]:
        if min(want["dense_gap"], want["bm25_gap"]) <= HYBRID_TOL:
            counts["channel_boundary"] += 1
            return 0.0
        if len(ids) != len(want["ids"]) or any(
                i not in of or abs(of[i][0] - of[w][0]) > HYBRID_TOL
                for i, w in zip(ids, want["ids"])):
            raise AssertionError(
                f"slice_hybrid {what}: ids {ids} differ from the oracle's "
                f"{want['ids']} with no near-tie to explain them")
        counts["near_tie"] += 1
    got = np.array([(d.score, d.semantic_score, d.keyword_score,
                     d.temporal_score) for d in docs])
    ref = np.array([of[i] for i in ids])
    err = np.abs(got - ref)
    err[:, 2] /= np.maximum(np.abs(ref[:, 2]), 1.0)
    bad = dict(zip(("fused", "sem", "kw", "tmp"), err.max(axis=0).tolist()))
    tol = {"fused": HYBRID_TOL, "sem": HYBRID_TOL, "kw": HYBRID_TOL,
           "tmp": TEMPORAL_TOL}
    over = {k: v for k, v in bad.items() if not v <= tol[k]}
    if over:
        raise AssertionError(f"slice_hybrid {what}: scores off the "
                             f"oracle's: {over} (tolerances {tol})")
    return bad["fused"]


def hold_dense_only(what, docs, oracle, j, k, counts):
    """dense_only's answer to query j against the exact float64 top-k, ties
    to the lower row; a differing id must score within HYBRID_TOL of the
    oracle's score at its rank (a near-tie), and is counted."""
    sem, rank = oracle.dense(j)
    o_ids, o_s = _top(rank, k)
    ids = np.array([d.doc_id for d in docs])
    vals = np.array([d.score for d in docs])
    if len(ids) != k:
        raise AssertionError(f"slice_hybrid {what}: {len(ids)} of {k} docs")
    if (ids != o_ids).any():
        if np.abs(sem[ids] - o_s).max() > HYBRID_TOL:
            raise AssertionError(f"slice_hybrid {what}: ids {ids.tolist()} "
                                 f"differ from the oracle's {o_ids.tolist()}")
        counts["near_tie"] += 1
    err = float(np.abs(vals - o_s).max())
    if not err <= HYBRID_TOL:
        raise AssertionError(f"slice_hybrid {what}: scores off by {err:.3g}")
    return err


def mmr_oracle(embs, blended, n, k):
    """FusedRerankEval's selection in float64: candidates padded to the
    bucket, sorted by blended score (ties to the lower index), greedy MMR
    over the sorted list. Returns (selected indices, each step's best and
    second-best objective)."""
    npad = next(b for b in (8, 16, 32) if n <= b)
    e = np.zeros((npad, embs.shape[1]))
    e[:n] = embs
    e /= np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
    bm = np.full(npad, -1e30)
    bm[:n] = blended
    order = np.argsort(-bm, kind="stable")
    es, rel, ok = e[order], bm[order], order < n
    sim = es @ es.T
    chosen, steps, max_sim = [], [], np.full(npad, -1e30)
    for _ in range(min(k, npad)):
        pen = max_sim if chosen else np.zeros(npad)
        obj = np.where(ok, LAM * rel - (1.0 - LAM) * pen, -1e30)
        obj[chosen] = -1e30
        j = int(np.argmax(obj))
        if obj[j] <= -1e29:
            break
        steps.append(np.sort(obj)[-2:][::-1])
        chosen.append(j)
        max_sim = np.maximum(max_sim, sim[j])
    if n <= k:
        return [int(i) for i in order if i < n], steps
    return [int(order[j]) for j in chosen], steps


def device_busy(fn, cpu=True):
    """``fn()`` under torch.profiler: host-clock wall ms (synchronised), the
    device time of its kernels (one stream: they do not overlap), the idle
    share, and the five kernels with the most device time. ``cpu=False``
    traces the device's activity alone, which costs the host less."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # The device's own events (kernels, copies, fills), read from the raw
    # trace: building the profiler's event tree costs the host seconds.
    by_name = Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns() / 1e6
    busy = sum(by_name.values())
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if busy else None,
            "top_kernels_ms": {k[:60]: v for k, v in by_name.most_common(5)}}


def route_stats(ms):
    ms = sorted(ms)
    return {"queries": len(ms), "p50_ms": statistics.median(ms),
            "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
            "mean_ms": statistics.fmean(ms)}


def phase_slice_hybrid(K_, T_, dev, svc, chunks, queries, smi):
    """The retrieval half of a chat turn at 262,144 chunks: ingest as the
    agent ingests (the pretrained BiEncoder embeds every chunk on the card
    in batches of 128 into a float32 DenseIndex at tile 1024; LexicalIndex
    with the agent's defaults); then 64 queries one at a time through the
    one-call and the two-call hybrid routes, dense_only at k=2 (certified:
    K1 -> K4) and k=10 (K6), FusedRerankEval on each one-call answer (modes
    ce and emb) beside the modular SelectiveReranker path, and the
    separate-dispatch route after 16 deletes (K6). Every answer is held
    against the float64 oracle; the cross-encoder's logits against the
    port's CPU run. Launch counts are set to 0 before each path and read
    after it. Resets the peak memory statistics. Returns the kernel
    records of the dense routes, each with its launches by path, and the
    ingested rows (on the host) for slice_components."""
    import dataclasses
    from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
    from optimized_rag_tpu_torch.engine.rerank import SelectiveReranker
    from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
    from optimized_rag_tpu_torch.engine.types import Intent, intent_weights
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.index.lexical import LexicalIndex
    from optimized_rag_tpu_torch.models.convert import load_crossencoder
    from optimized_rag_tpu_torch.ops import fused_query as FQ
    from optimized_rag_tpu_torch.ops.fused_eval import rerank_eval_fused
    from optimized_rag_tpu_torch.ops.hybrid import (
        bm25_channel, dense_channel, score_candidates)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(HERE, "checkpoints", "pretrained")
    texts = hybrid_corpus(chunks, N_HYBRID)
    created = (time.time() - np.random.default_rng(SEED + 3).random(
        N_HYBRID) * 365 * 86400).tolist()
    created32 = np.asarray([c / 86400.0 for c in created], np.float32)

    # Ingest: encode in batches of 128 into the DenseIndex, then the
    # lexical index (add, then build).
    with svc._cache_lock:
        svc._cache.clear()
    index = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK, tile=TILE,
                       dtype=torch.float32, device=dev)
    t1 = time.perf_counter()
    for lo in range(0, N_HYBRID, INGEST_BATCH):
        index.add(svc.encode(texts[lo:lo + INGEST_BATCH]))
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t1
    corpus_rows = index.embeddings()[:N_HYBRID].cpu()   # slice_components
    lexical = LexicalIndex(device=dev)
    t1 = time.perf_counter()
    lexical.add(texts)
    t_lex_add = time.perf_counter() - t1
    t1 = time.perf_counter()
    lexical.build()
    torch.cuda.synchronize()
    t_lex_build = time.perf_counter() - t1
    ce = load_crossencoder(ckpt, device=dev)
    with svc._cache_lock:                 # queries miss, as a user's would
        svc._cache.clear()

    mk = lambda encoder: HybridRetriever(
        index, lexical, svc.encode, get_text=texts.__getitem__,
        get_created_at=created.__getitem__, half_life_days=HALF_LIFE,
        candidate_k=CANDIDATE_K, encoder=encoder)
    one_call, two_call = mk(svc), mk(None)
    for r in (one_call, two_call):        # warm-up, not timed or held
        r.retrieve("warm-up request", TOP_K, Intent.QUESTION_ANSWERING)
        svc._cache.pop("warm-up request", None)
    w_qa = np.asarray(intent_weights(Intent.QUESTION_ANSWERING), np.float32)
    paths, log, times, counts, nows = {}, {}, {}, {}, [0.0] * len(queries)

    def drive(name, fn, record=False):
        """``fn(j, text)`` for every query, launches counted over the whole
        path (and, with ``record``, every kernel call recorded); host-clock
        ms per query. Returns the answers."""
        calls = log.setdefault(name, [])
        out, ms = [], []
        with recording(T_, K_, calls) if record else contextlib.nullcontext():
            K_.reset_launch_counts()
            for j, text in enumerate(queries):
                t_q = time.perf_counter()
                out.append(fn(j, text))
                ms.append((time.perf_counter() - t_q) * 1e3)
            paths[name] = K_.launch_counts()
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if record and seen != paths[name]:
            raise AssertionError(f"slice_hybrid {name}: recorded {seen}, "
                                 f"counted {paths[name]}")
        times[name] = route_stats(ms)
        return out

    def hybrid(retriever, **kw):
        """A hybrid query at question_answering's weights; the oracle
        reads now just before the call."""
        def ask(j, text):
            nows[j] = time.time()
            return retriever.retrieve(text, TOP_K, Intent.QUESTION_ANSWERING,
                                      **{k: v[j] for k, v in kw.items()})
        return ask

    def host_ages(j):
        """The separate routes' ages: float64 seconds on the host, then
        float32 days."""
        return lambda c: np.asarray([np.float32(
            (nows[j] - created[i]) / 86400.0) for i in c], np.float64)

    def hold_route(name, answers, ages_of):
        counts[name] = {"near_tie": 0, "channel_boundary": 0}
        return max(hold_hybrid(f"{name} query {j}", answers[j],
                               oracle.hybrid(j, text, ages_of(j), w_qa),
                               counts[name])
                   for j, text in enumerate(queries))

    # (a) The one-call route; the query vectors ride back in the packed
    # result's row 5 into the encoder's cache. The one-call route's ages
    # are float32 days on the card: now, rounded to float32, minus each
    # row's float32 days.
    answers_a = drive("one_call", hybrid(one_call))
    q_emb = np.stack([svc._cache[text] for text in queries])
    oracle = HybridOracle(lexical, index, q_emb)
    err_a = hold_route("one_call", answers_a, lambda j: lambda c: np.maximum(
        np.float64(np.float32(nows[j] / 86400.0))
        - created32[c].astype(np.float64), 0.0))

    # The device's busy and idle time over 16 one-call queries (under the
    # profiler, which adds host time).
    trace = device_busy(lambda: [one_call.retrieve(
        text, TOP_K, Intent.QUESTION_ANSWERING) for text in queries[:16]])

    # (b) The two-call route on (a)'s query vectors: the same answers.
    answers_b = drive("two_call", hybrid(two_call, query_embedding=q_emb))
    err_b = hold_route("two_call", answers_b, host_ages)
    for j, (a, b) in enumerate(zip(answers_a, answers_b)):
        if [d.doc_id for d in a] != [d.doc_id for d in b] or max(
                abs(x.score - y.score) for x, y in zip(a, b)) > HYBRID_TOL:
            raise AssertionError(f"slice_hybrid query {j}: the one-call and "
                                 "two-call routes answer differently")

    # (c) dense_only (use_hybrid=False intents) through DenseIndex.search:
    # k=2 takes the certified path (K1 -> K4), k=10 the tiled search (K6).
    for name, k, intent in (("dense_only_k2", 2, Intent.CONVERSATIONAL),
                            ("dense_only_k10", 10, Intent.SUMMARIZATION)):
        got = drive(name, lambda j, text, k=k, intent=intent:
                    one_call.retrieve(text, k, intent), record=True)
        counts[name] = {"near_tie": 0}
        for j in range(len(queries)):
            hold_dense_only(f"{name} query {j}", got[j], oracle, j, k,
                            counts[name])

    # (e) FusedRerankEval on each one-call answer, modes ce and emb, beside
    # the modular SelectiveReranker.rerank -> apply_mmr on the same docs.
    # The answers' texts are embedded first, so both paths find them in the
    # cache (stage "embed_10_texts" times that forward), and each path runs
    # once untimed on the warm-up answer (the first forward of a shape pays
    # for the library's set-up).
    mk_rr = lambda: SelectiveReranker(cross_encoder=ce, embed_fn=svc.encode,
                                      device=dev)
    copy = lambda docs: [dataclasses.replace(d) for d in docs]
    svc.encode([d.text for docs in answers_a for d in docs])
    warm = one_call.retrieve("warm-up request", TOP_K,
                             Intent.QUESTION_ANSWERING)
    for intent in (Intent.QUESTION_ANSWERING, Intent.SEARCH):
        rr = mk_rr()
        FusedRerankEval(rr, svc.encode, cross_encoder=ce).run(
            "warm-up request", copy(warm), intent, k_mmr=K_MMR, lam=LAM)
        rr.apply_mmr(rr.rerank("warm-up request", copy(warm), intent),
                     k=K_MMR, lam=LAM)
    fe = FusedRerankEval(mk_rr(), svc.encode, cross_encoder=ce)
    for mode, intent in (("ce", Intent.QUESTION_ANSWERING),
                         ("emb", Intent.SEARCH)):
        def fused(j, text, intent=intent):
            docs = copy(answers_a[j])
            return fe.run(text, docs, intent, k_mmr=K_MMR, lam=LAM), docs
        runs = drive(f"fused_eval_{mode}", fused)
        rr = mk_rr()
        modular = drive(f"modular_{mode}", lambda j, text, intent=intent,
                        rr=rr: rr.apply_mmr(rr.rerank(
                            text, copy(answers_a[j]), intent), k=K_MMR,
                            lam=LAM))
        counts[f"fused_eval_{mode}"] = {"mmr_near_tie": 0}
        for j, text in enumerate(queries):
            (res, docs), sel = runs[j], [d.doc_id for d in runs[j][0]["docs"]]
            if sel != [d.doc_id for d in modular[j]]:
                raise AssertionError(f"slice_hybrid {mode} query {j}: fused "
                                     f"{sel} != modular "
                                     f"{[d.doc_id for d in modular[j]]}")
            embs = svc.encode([text] + [d.text for d in docs])
            want, steps = mmr_oracle(embs[1:], [d.score for d in docs],
                                     len(docs), K_MMR)
            if sel != [docs[i].doc_id for i in want]:
                if not any(s[0] - s[1] <= HYBRID_TOL for s in steps):
                    raise AssertionError(f"slice_hybrid {mode} query {j}: "
                                         "MMR selection differs from the "
                                         "oracle's")
                counts[f"fused_eval_{mode}"]["mmr_near_tie"] += 1
                continue
            dn = embs[1:][want].astype(np.float64)
            dn /= np.maximum(np.linalg.norm(dn, axis=1, keepdims=True),
                             1e-12)
            qn = embs[0] / max(np.linalg.norm(embs[0]), 1e-12)
            rel = np.clip((dn @ qn + 1.0) / 2.0, 0.0, 1.0)
            bad = max(float(np.abs(np.asarray(res["per_doc"]) - rel).max()),
                      float(np.abs(res["sim"] - dn @ dn.T).max()))
            if not bad <= HYBRID_TOL:
                raise AssertionError(f"slice_hybrid {mode} query {j}: "
                                     f"relevance or sim off by {bad:.3g}")
    stats = fe.reranker.stats
    if stats["reranked"] != len(queries) or \
            stats["embedding_reranked"] != len(queries):
        raise AssertionError(f"slice_hybrid: fused routing {stats}")

    # The cross-encoder on the card against the port's CPU run of the same
    # pairs (8 queries x the first answer's docs).
    ce_cpu = load_crossencoder(ckpt, device="cpu")
    pairs = ce.tokenizer.encode_pairs(
        [(text, d.text) for text in queries[:8] for d in answers_a[0]],
        ce.max_len)
    logit_err = float(np.abs(ce.logits(*pairs).cpu().numpy()
                             - ce_cpu.logits(*pairs).numpy()).max())
    if not logit_err <= LOGIT_ATOL:
        raise AssertionError(f"slice_hybrid: cross-encoder logits on the "
                             f"card off the CPU's by {logit_err:.3g}")
    del ce_cpu

    # (d) 16 deletes (rows the one-call route answered): separate calls,
    # DenseIndex.search at k = 50 + 16 (K6), LexicalIndex.search, and
    # fuse_candidates. BM25 still finds deleted rows; their score is 0.
    dead = list(dict.fromkeys(d.doc_id for docs in answers_a
                              for d in docs))[:N_DELETED]
    index.delete(dead)
    oracle.delete(dead)
    answers_d = drive("tombstones", hybrid(one_call), record=True)
    err_d = hold_route("tombstones", answers_d, host_ages)
    require_launched(paths, ("dense_only_k2",), ("packed_extract", "extract"),
                     "slice_hybrid dense_only k=2")
    require_launched(paths, ("dense_only_k10",), ("tile_topk",),
                     "slice_hybrid dense_only k=10")
    require_launched(paths, ("tombstones",), ("tile_topk",),
                     "slice_hybrid tombstone")

    # Where a query's time goes on the card: each stage alone on the first
    # query's inputs, CUDA events.
    text, now_days = queries[0], time.time() / 86400.0
    q_ids, q_mask = svc.tokenizer.encode_batch([text], svc.max_len)
    dvc = lexical._device
    lex_args = (*lexical.query_tensors(text), dvc["champ_docs"],
                dvc["champ_tf"], dvc["champ_valid"], dvc["idf"],
                dvc["doc_len"], dvc["avg_len"])
    emb, size = index.embeddings(), index.size
    qv = FQ.encode_query_vector(svc.model, q_ids, q_mask)
    d_s, d_i = dense_channel(qv, emb, CANDIDATE_K, size)
    b_s, b_i = bm25_channel(*lex_args, CANDIDATE_K, size, 1.5, 0.75)
    created_dev = one_call._created_days()
    w_dev = torch.as_tensor(w_qa, device=dev)

    def fuse():
        cand, ok, kw = FQ.union_candidates(d_s[0], d_i[0], b_s, b_i)
        safe = cand.clamp_min(0)
        ages = torch.clamp_min(now_days - created_dev[safe], 0.0)
        return T_._topk(score_candidates(qv[0], emb, safe, kw, ages, ok,
                                         w_dev, HALF_LIFE)[0], TOP_K)
    docs0 = answers_a[0]
    n0 = len(docs0)
    pad = lambda a: np.pad(a, [(0, 16 - n0)] + [(0, 0)] * (a.ndim - 1))
    pairs0 = ce.tokenizer.encode_pairs([(text, d.text) for d in docs0],
                                       ce.max_len)
    e0 = svc.encode([text] + [d.text for d in docs0])
    texts0 = [d.text for d in docs0]

    def embed_texts():                    # cache misses, as at first sight
        with svc._cache_lock:
            svc._cache.clear()
        return svc.encode(texts0)
    stages = {
        "encoder_forward": lambda: FQ.encode_query_vector(svc.model, q_ids,
                                                          q_mask),
        f"embed_{n0}_texts": embed_texts,
        "dense_channel": lambda: dense_channel(qv, emb, CANDIDATE_K, size),
        "bm25_channel": lambda: bm25_channel(*lex_args, CANDIDATE_K, size,
                                             1.5, 0.75),
        "union_and_fusion": fuse,
        "encode_and_retrieve": lambda: FQ.encode_and_retrieve(
            svc.model, q_ids, q_mask, emb, size, *lex_args, created_dev,
            now_days, w_qa, HALF_LIFE, matryoshka_dim=None,
            candidate_k=CANDIDATE_K, k=TOP_K),
        f"ce_forward_{n0}_pairs": lambda: ce.logits(*pairs0),
        "rerank_eval_fused_ce": lambda: rerank_eval_fused(
            ce.model, *map(pad, pairs0), pad(e0[1:]), e0[0],
            pad(np.asarray([d.score for d in docs0], np.float32)),
            np.arange(16) < n0, 0.3, LAM, k_mmr=K_MMR, mode="ce",
            device=dev)}
    stage_ms = {name: median_ms(fn, 20) for name, fn in stages.items()}

    held = hold_recorded(K_, T_, {p: log[p] for p in HYBRID_KERNEL_PATHS},
                         5, "slice_hybrid")
    emit({"phase": "slice_hybrid", "card": smi, "chunks": index.size,
          "dim": DIM, "tile": TILE, "queries": len(queries),
          "top_k": TOP_K, "candidate_k": CANDIDATE_K, "deleted": len(dead),
          "lexical_terms": len(lexical._row_of),
          "champ_shape": list(dvc["champ_docs"].shape),
          "ingest_chunks_per_s": index.size / t_embed,
          "ingest_embed_seconds": t_embed,
          "lexical_add_seconds": t_lex_add,
          "lexical_build_seconds": t_lex_build,
          "routes_host_ms": times, "stages_cuda_ms": stage_ms,
          "one_call_trace_16_queries": trace,
          "oracle_max_fused_err": {"one_call": err_a, "two_call": err_b,
                                   "tombstones": err_d},
          "allowed_differences": counts, "ce_logit_err_vs_cpu": logit_err,
          "fused_eval_stats": stats, "launches_by_path": paths,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_hybrid", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    del index, lexical, oracle, one_call, two_call, ce, fe, emb, qv
    torch.cuda.empty_cache()
    return held, corpus_rows


# ------------------------------------------------------- slice_components

N_ARCHIVAL = 65_536               # archived notes: about a year of use
ARCHIVAL_BATCH = 128              # bulk_insert_archival batch
ARCHIVAL_K = 5                    # archival_memory_search's top_k
N_ARCHIVAL_QUERIES = 64
N_VOCAB_FILLERS = 4_096           # fillers the two tokenizers must agree on
N_LEX_QUERIES = 64
N_CLIENT_REQUESTS = 16            # EmbedBatcher: 8 clients x 16 requests
MAX_REQUEST_TEXTS = 24
N_CONSISTENCY_SETS, SET_SIZE = 16, 10
N_DEDUP = 512
MIN_COSINE = 0.9999               # tests/test_torch_encoder.py, bf16 trunk
THRESHOLD_TIE = 1e-6              # float64 distance that counts a tie
COMPONENT_KERNEL_PATHS = ("archival_65536", "archival_69632", "corpus_k2",
                          "snapshot_corpus_k2", "snapshot_archival",
                          "trace_archival")


def filler_texts(chunks, n, seed):
    """``n`` seeded FILLER_WORDS-word texts of the chunks' own words."""
    words = [w for c in chunks for w in c.split()]
    rng = random.Random(seed)
    return [" ".join(rng.choices(words, k=FILLER_WORDS)) for _ in range(n)]


@contextlib.contextmanager
def python_path(native):
    """The Python analyzer and tokenizers inside the block: the native
    entry points decline every text, as they decline non-ASCII text."""
    names = ("term_counts", "model_tokenize", "vocab_tokenize")
    saved = [getattr(native, n) for n in names]
    for n in names:
        setattr(native, n, lambda *args: None)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(native, n, fn)


def hold_semantic_keep(kept, sim64, threshold):
    """Semantic dedup's kept positions (among the texts it embedded) against
    its rule in float64: a text stays while its cosine to every text kept
    before it is below ``threshold``. Each decision is judged after the
    kept list's own earlier decisions, and may differ from the rule only
    through pairs within THRESHOLD_TIE of the threshold. Returns the number
    of decisions that a tie settled."""
    kept_set, final, settled = set(kept), [], 0
    for a in range(sim64.shape[0]):
        s = sim64[a, final]
        dup = s >= threshold
        tie = np.abs(s - threshold) <= THRESHOLD_TIE
        keep = a in kept_set
        if keep == (not dup.any()):
            pass
        elif (keep and (dup & ~tie).any()) or (not keep and not tie.any()):
            raise AssertionError(f"slice_components dedup: text {a} "
                                 f"{'kept' if keep else 'dropped'} against "
                                 f"the rule (cosines {s[dup | tie]})")
        else:
            settled += 1
        if keep:
            final.append(a)
    return settled


def collision_cells(lex, lex_py, texts):
    """The (term id, document) postings where the C++ analyzer's index
    ``lex`` and the Python analyzer's ``lex_py`` differ. Each must be a
    document with several stems of that hashed id, whose C++ count is their
    sum and whose Python count is that of the stem seen last (the JAX
    package's two paths differ so too); any other difference raises."""
    from optimized_rag_tpu_torch.index.lexical import lexical_tokens
    if lex._postings.keys() != lex_py._postings.keys():
        raise AssertionError("slice_components: native and Python term "
                             "sets differ")
    cells = []
    for t, p in lex._postings.items():
        q = lex_py._postings[t]
        if p == q:
            continue
        if p.keys() != q.keys():
            raise AssertionError(f"slice_components: term {t} is in other "
                                 "documents natively than in Python")
        cells += [(t, d) for d in p if p[d] != q[d]]
    for t, d in cells:
        stems = [(w, c) for w, c in Counter(lexical_tokens(texts[d])).items()
                 if lex_py._term_id(w) == t]
        if not (len(stems) > 1
                and lex._postings[t][d] == sum(c for _, c in stems)
                and lex_py._postings[t][d] == stems[-1][1]):
            raise AssertionError(
                f"slice_components: term {t} of document {d} counts "
                f"{lex._postings[t][d]} natively and {lex_py._postings[t][d]}"
                f" in Python; its stems {stems}")
    return cells


def hold_archival(what, got, rows64, q, counts):
    """An archival answer (ids, scores of the top ARCHIVAL_K) against the
    float64 oracle over the index's rows fed the query embedding the card
    computed: ids equal, scores within TIE_TOL; a differing id must score
    within TIE_TOL of the oracle's score at its rank (a near-tie), and is
    counted. Returns the worst score error."""
    qn = np.asarray(q, np.float64)
    qn /= max(np.linalg.norm(qn), 1e-12)
    sem = rows64 @ qn
    o_ids, o_s = _top(sem, ARCHIVAL_K)
    ids, vals = np.asarray(got[0]), np.asarray(got[1], np.float64)
    if len(ids) != len(o_ids):
        raise AssertionError(f"{what}: {len(ids)} of "
                             f"{len(o_ids)} hits")
    if (ids != o_ids).any():
        if np.abs(sem[ids] - o_s).max() > TIE_TOL:
            raise AssertionError(f"{what}: ids "
                                 f"{ids.tolist()} differ from the oracle's "
                                 f"{o_ids.tolist()}")
        counts["near_tie"] += 1
    err = float(np.abs(vals - o_s).max())
    if not err <= TIE_TOL:
        raise AssertionError(f"{what}: scores off by "
                             f"{err:.3g}")
    return err


def negated_and_renumbered(sentence, rng):
    """A copy of ``sentence`` that contradicts it: "is" -> "is not" (or
    "are" -> "are not"), else its first number changed; None if neither
    applies."""
    for verb in (" is ", " are "):
        if verb in sentence and rng.random() < 0.6:
            return sentence.replace(verb, f"{verb}not ", 1)
    m = re.search(r"\b\d+\b", sentence)
    if m:
        return (sentence[:m.start()] + str(int(m.group()) + 7)
                + sentence[m.end():])
    for verb in (" is ", " are "):
        if verb in sentence:
            return sentence.replace(verb, f"{verb}not ", 1)
    return None


def consistency_sets(chunks, rng):
    """N_CONSISTENCY_SETS sets of SET_SIZE qa_docs sentences, each with
    seeded contradicting copies (``negated_and_renumbered``) of some of its
    sentences, shuffled."""
    sents = [s.strip() for c in chunks
             for s in re.split(r"(?<=[.?!])\s+|\n+", c) if len(s.split()) > 3]
    out = []
    for _ in range(N_CONSISTENCY_SETS):
        base = rng.sample(sents, SET_SIZE)
        n_copies = rng.randint(2, 4)
        keep, copies = base[:SET_SIZE - n_copies], []
        for s in rng.sample(base[:SET_SIZE - n_copies], n_copies):
            c = negated_and_renumbered(s, rng)
            copies.append(c if c is not None else base[len(keep)
                                                       + len(copies)])
        texts = keep + copies
        rng.shuffle(texts)
        out.append(texts)
    return out


def dedup_texts(chunks, rng):
    """N_DEDUP texts: qa_docs sentences and seeded fillers of 6-40 words,
    followed by near-duplicates of earlier ones: case copies (exact dedup),
    one word dropped (fuzzy), and 15-25% of the words dropped (left to the
    semantic pass)."""
    sents = [s.strip() for c in chunks
             for s in re.split(r"(?<=[.?!])\s+|\n+", c) if len(s.split()) > 3]
    words = [w for c in chunks for w in c.split()]
    n_base = N_DEDUP * 3 // 4
    base = sents[:n_base] + [" ".join(rng.choices(words, k=rng.randint(
        6, 40))) for _ in range(n_base - min(n_base, len(sents)))]
    dups = []
    for j in range(N_DEDUP - n_base):
        src = base[rng.randrange(n_base)].split()
        kind = j % 4
        if kind == 0:
            dups.append(" ".join(src).upper())
        elif kind == 1 and len(src) > 12:
            del src[rng.randrange(len(src))]
            dups.append(" ".join(src))
        else:
            drop = set(rng.sample(range(len(src)), max(1, len(src) // 5)))
            dups.append(" ".join(w for i, w in enumerate(src)
                                 if i not in drop))
    return base + dups


def phase_slice_components(K_, T_, dev, svc, chunks, queries, corpus_rows,
                           smi):
    """The components a chat turn's nodes consume, on the card at full
    width (the pretrained BiEncoder through EmbeddingService):
    (a) the C++ analyzer (built by g++ into build/native/) against the
    Python one: two LexicalIndexes over slice_hybrid's 262,144 chunks, and
    the hash and learned-vocabulary tokenizers; (b) archival memory:
    MemoryManager over MetadataStore(":memory:") and an EmbedBatcher, 65,536
    archived notes, 64 searches (K6 at N=65,536), one insert (the index
    grows to 69,632 rows), 64 more (K6 at 69,632), each held against a
    float64 oracle; (c) EmbedBatcher under 8 concurrent clients against
    direct encodes; (d) ConsistencyChecker and semantic dedup with their
    pairwise cosine on the card against a float64 oracle; (e) snapshots of
    the archival index, a 262,144-row corpus DenseIndex (slice_hybrid's
    rows; k=2 searches certify: K1 -> K4) and the native LexicalIndex,
    loaded back onto the card, searches bit-identical; (f) the index
    policy, the health probe, a device trace of 16 archival searches that
    must name K6's kernel, and the phase's StageTimer spans. Launch counts
    are set to 0 before each kernel path and read after it. Resets the
    peak memory statistics. Returns the kernel records of its paths."""
    import shutil
    import tempfile
    from optimized_rag_tpu_torch import native
    from optimized_rag_tpu_torch.config import Settings
    from optimized_rag_tpu_torch.engine.consistency import (
        ConsistencyChecker, is_contradiction)
    from optimized_rag_tpu_torch.engine.types import RetrievedDoc
    from optimized_rag_tpu_torch.engine.wrangler import Deduplicator
    from optimized_rag_tpu_torch.index import snapshot
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.index.lexical import LexicalIndex
    from optimized_rag_tpu_torch.index.policy import (
        build_index_for, select_index_kind)
    from optimized_rag_tpu_torch.models.tokenizer import (
        HashTokenizer, VocabTokenizer)
    from optimized_rag_tpu_torch.ops.similarity import pairwise_cosine
    from optimized_rag_tpu_torch.serving import EmbedBatcher
    from optimized_rag_tpu_torch.store.db import MetadataStore
    from optimized_rag_tpu_torch.store.memory import MemoryManager
    from optimized_rag_tpu_torch.utils.health import check_device_health
    from optimized_rag_tpu_torch.utils.profiling import (
        StageTimer, device_trace)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    timer, rep, counts = StageTimer(), {}, {}
    paths, log = {}, {}
    rng = random.Random(SEED + 11)
    texts = hybrid_corpus(chunks, N_HYBRID)
    work = tempfile.mkdtemp(prefix="slice_components-",
                            dir=os.path.join(HERE, "build"))

    def drive(name, fn):
        """``fn()`` with launch counts from 0 and every kernel call
        recorded; the recorded calls must equal the counted launches."""
        calls = log.setdefault(name, [])
        with recording(T_, K_, calls):
            K_.reset_launch_counts()
            out = fn()
            paths[name] = K_.launch_counts()
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if seen != paths[name]:
            raise AssertionError(f"slice_components {name}: recorded {seen},"
                                 f" counted {paths[name]}")
        return out

    def cached_clear():
        with svc._cache_lock:
            svc._cache.clear()

    try:
        # (a) The C++ analyzer against the Python one.
        with timer.span("native_analyzer"):
            t1 = time.perf_counter()
            if not native.available():
                raise AssertionError("the native analyzer is not available")
            lib = os.path.relpath(native.library_path(), HERE)
            if not lib.startswith(os.path.join("build", "native") + os.sep):
                raise AssertionError(f"native library outside build/: {lib}")
            rep["native_load_seconds"] = time.perf_counter() - t1
            rep["native_library"] = lib
            lex, lex_py = (LexicalIndex(device=dev) for _ in range(2))
            t1 = time.perf_counter()
            lex.add(texts)
            rep["lexical_add_native_seconds"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            with python_path(native):
                lex_py.add(texts)
            rep["lexical_add_python_seconds"] = time.perf_counter() - t1
            for idx in (lex, lex_py):
                idx.build()
            # The two analyzers differ only where a document's stems share
            # a hashed id (collision_cells): those documents are counted,
            # and the champion rows and searches of those ids left out.
            cells = collision_cells(lex, lex_py, texts)
            if lex._row_of != lex_py._row_of or lex._doc_len != \
                    lex_py._doc_len:
                raise AssertionError("slice_components: native and Python "
                                     "postings differ")
            rows_hit = sorted({lex._row_of[t] for t, _ in cells})
            for key, v in lex._device.items():
                w = lex_py._device[key]
                if key.startswith("champ"):
                    other = torch.ones(v.shape[0], dtype=torch.bool,
                                       device=v.device)
                    other[rows_hit] = False
                    v, w = v[other], w[other]
                if not torch.equal(v, w):
                    raise AssertionError(f"slice_components: build array "
                                         f"{key} differs native/Python")
            lex_queries = queries[:N_LEX_QUERIES]
            touched = 0
            for text in lex_queries:
                q_rows, q_valid = lex.encode_query(text)
                if set(q_rows[q_valid].tolist()) & set(rows_hit):
                    touched += 1
                    continue
                (s1, i1), (s2, i2) = lex.search(text, 10), lex_py.search(
                    text, 10)
                if not (np.array_equal(i1, i2) and np.array_equal(s1, s2)):
                    raise AssertionError(f"slice_components: lexical search "
                                         f"{text!r} differs native/Python")
            counts["analyzer"] = {
                "colliding_documents": len({d for _, d in cells}),
                "colliding_term_ids": sorted({t for t, _ in cells}),
                "searches_over_colliding_ids": touched}
            del lex_py
            # The hashing tokenizer and the pretrained learned vocabulary
            # (the service's own tokenizer), natively and in Python.
            tok_texts = chunks + filler_texts(chunks, N_VOCAB_FILLERS,
                                              SEED + 13)
            vocab_tok = svc.tokenizer
            hashed = HashTokenizer(svc.cfg.vocab_size, svc.max_len)
            if not isinstance(vocab_tok, VocabTokenizer):
                raise AssertionError("the pretrained tokenizer is not a "
                                     "learned vocabulary")
            fast = [(hashed.tokenize(t), vocab_tok.tokenize(t))
                    for t in tok_texts]
            if vocab_tok._native_handle is None:
                raise AssertionError("VocabTokenizer has no native handle")
            with python_path(native):
                slow = [(hashed.tokenize(t), vocab_tok.tokenize(t))
                        for t in tok_texts]
            mismatched = sum(a != b for a, b in zip(fast, slow))
            if mismatched:
                raise AssertionError(f"slice_components: {mismatched} "
                                     "tokenizations differ native/Python")
            rep["tokenizer_texts"] = len(tok_texts)
            # PERF.md section 5: the Python add recorded there before the
            # C++ analyzer took the add over, for comparison.
            rep["lexical_add_python_seconds_recorded"] = 9.64

        # (b) Archival memory: a year of notes, searched one at a time.
        with timer.span("archival_memory"):
            notes = filler_texts(chunks, N_ARCHIVAL + 1, SEED + 17)
            batcher = EmbedBatcher(svc.encode).start()
            seen_q = []

            def embed(batch):
                out = batcher.encode(batch)
                seen_q.append(out)
                return out
            store = MetadataStore(":memory:")
            mem = MemoryManager(store, embed_fn=embed, device=dev)
            t1 = time.perf_counter()
            for lo in range(0, N_ARCHIVAL, ARCHIVAL_BATCH):
                mem.bulk_insert_archival(notes[lo:lo + ARCHIVAL_BATCH])
            torch.cuda.synchronize()
            seen_q.clear()
            rep["archival_insert_rows_per_s"] = N_ARCHIVAL / (
                time.perf_counter() - t1)
            counts["archival"] = {"near_tie": 0}
            errs, search_ms = [], {}

            def ask(name, texts_):
                """archival_memory_search of each text alone; returns the
                (ids, scores) answers and the query embeddings used."""
                ms, answers, q_embs = [], [], []
                for text in texts_:
                    t_q = time.perf_counter()
                    hits = mem.archival_memory_search(text, ARCHIVAL_K)
                    ms.append((time.perf_counter() - t_q) * 1e3)
                    answers.append(([d.doc_id for d in hits],
                                    [d.score for d in hits]))
                    q_embs.append(seen_q[-1][0])
                search_ms[name] = route_stats(ms)
                return answers, q_embs

            def hold_all(name, answers, q_embs):
                rows64 = mem.archival.embeddings()[:mem.archival.size] \
                    .cpu().numpy().astype(np.float64)
                return max(hold_archival(f"slice_components {name} query {j}",
                                         a, rows64, q, counts["archival"])
                           for j, (a, q) in enumerate(zip(answers, q_embs)))

            if mem.archival.capacity != N_ARCHIVAL:
                raise AssertionError(f"archival capacity "
                                     f"{mem.archival.capacity}")
            first_q = queries[:N_ARCHIVAL_QUERIES]
            ans1, qe1 = drive("archival_65536", lambda: ask(
                "archival_65536", first_q))
            errs.append(hold_all("archival_65536", ans1, qe1))
            new_text = notes[N_ARCHIVAL]
            new_id = mem.archival_memory_insert(new_text, {"kind": "note"})
            cap2 = mem.archival.capacity
            if cap2 != N_ARCHIVAL + 4096:
                raise AssertionError(f"archival capacity after the insert "
                                     f"{cap2}")
            second_q = queries[N_ARCHIVAL_QUERIES:2 * N_ARCHIVAL_QUERIES - 1] \
                + [new_text]
            ans2, qe2 = drive("archival_69632", lambda: ask(
                "archival_69632", second_q))
            errs.append(hold_all("archival_69632", ans2, qe2))
            if ans2[-1][0][0] != new_id:
                raise AssertionError(f"slice_components: the new note "
                                     f"{new_id} is not first for its own "
                                     f"text: {ans2[-1][0]}")
            batcher.stop()
            require_launched(paths, ("archival_65536",), ("tile_topk",),
                             "archival search (65,536 rows)")
            require_launched(paths, ("archival_69632",), ("tile_topk",),
                             "archival search (69,632 rows)")
            rep["archival"] = {"rows": mem.archival.size,
                               "capacity": [N_ARCHIVAL, cap2],
                               "search_host_ms": search_ms,
                               "oracle_max_err": max(errs)}

        # (c) EmbedBatcher: concurrent chat turns embedding claims.
        with timer.span("embed_batcher"):
            req_rng = random.Random(SEED + 19)
            pool = iter(filler_texts(chunks, N_CLIENTS * N_CLIENT_REQUESTS
                                     * MAX_REQUEST_TEXTS, SEED + 19))
            requests = [[next(pool) for _ in range(req_rng.randint(
                1, MAX_REQUEST_TEXTS))]
                for _ in range(N_CLIENTS * N_CLIENT_REQUESTS)]

            def load(encode):
                out, errors = [None] * len(requests), []

                def client(c):
                    try:
                        for i in range(c, len(requests), N_CLIENTS):
                            out[i] = encode(requests[i])
                    except BaseException as exc:   # reported below
                        errors.append(exc)
                threads = [threading.Thread(target=client, args=(c,),
                                            daemon=True)
                           for c in range(N_CLIENTS)]
                t_l = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                wall = time.perf_counter() - t_l
                if errors:
                    raise errors[0]
                if any(t.is_alive() for t in threads):
                    raise AssertionError("EmbedBatcher clients still alive")
                return out, wall
            coalescer = EmbedBatcher(svc.encode, max_texts=256).start()
            cached_clear()
            coalesced, wall_c = load(coalescer.encode)
            coalescer.stop()
            if coalescer._thread.is_alive():
                raise AssertionError("EmbedBatcher worker still alive")
            cached_clear()
            direct, wall_d = load(svc.encode)
            worst = 1.0
            for a, b in zip(coalesced, direct):
                norms = np.linalg.norm(a, axis=1)
                if not np.abs(norms - 1.0).max() <= 1e-5:
                    raise AssertionError("EmbedBatcher: rows not unit-norm")
                worst = min(worst, float(np.sum(a * b, axis=1).min()))
            if not worst >= MIN_COSINE:
                raise AssertionError(f"EmbedBatcher: cosine {worst} to the "
                                     f"direct encode < {MIN_COSINE}")
            st = dict(coalescer.stats)
            if not st["dispatches"] < st["requests"]:
                raise AssertionError(f"EmbedBatcher did not coalesce: {st}")
            rep["embed_batcher"] = {**st, "min_cosine_to_direct": worst,
                                    "coalesced_wall_s": wall_c,
                                    "direct_wall_s": wall_d}

        # (d) Consistency and semantic dedup, scored on the card.
        with timer.span("consistency_dedup"):
            got_emb = []

            def rec_embed(batch):
                out = svc.encode(batch)
                got_emb.append(out)
                return out
            checker = ConsistencyChecker(rec_embed, device=dev)
            counts["consistency"] = {"threshold_ties": 0}
            n_contra, ms_check, cos_err = 0, [], 0.0
            for s, sent_set in enumerate(consistency_sets(chunks, rng)):
                docs = [RetrievedDoc(doc_id=i, score=1.0, text=t)
                        for i, t in enumerate(sent_set)]
                t_c = time.perf_counter()
                res = checker.check_consistency(docs)
                ms_check.append((time.perf_counter() - t_c) * 1e3)
                e = got_emb[-1]
                e64 = e.astype(np.float64)
                e64 /= np.maximum(np.linalg.norm(e64, axis=1, keepdims=True),
                                  1e-12)
                sim64 = e64 @ e64.T
                card = pairwise_cosine(torch.from_numpy(e).to(dev)).cpu() \
                    .numpy()
                cos_err = max(cos_err, float(np.abs(card - sim64).max()))
                want = [(i, j) for i in range(len(docs))
                        for j in range(i + 1, len(docs))
                        if sim64[i, j] >= checker.sim_threshold
                        and is_contradiction(sent_set[i], sent_set[j])]
                got = [(i, j) for i, j, _ in res["contradictions"]]
                ties = [(i, j) for i in range(len(docs))
                        for j in range(i + 1, len(docs))
                        if abs(sim64[i, j] - checker.sim_threshold)
                        <= THRESHOLD_TIE]
                counts["consistency"]["threshold_ties"] += len(ties)
                if (set(got) ^ set(want)) - set(ties):
                    raise AssertionError(f"slice_components consistency set "
                                         f"{s}: {got} != oracle {want}")
                n_contra += len(got)
            if not cos_err <= TIE_TOL:
                raise AssertionError(f"pairwise_cosine on the card off "
                                     f"float64 by {cos_err:.3g}")
            if not n_contra:
                raise AssertionError("no contradiction found in any set")
            dtexts = dedup_texts(chunks, rng)
            got_emb.clear()
            seen_in = []

            def dedup_embed(batch):
                seen_in.append(list(batch))
                return rec_embed(batch)
            dd = Deduplicator(embed_fn=dedup_embed, device=dev)
            t_d = time.perf_counter()
            kept = dd.dedup(dtexts, semantic=True)
            dedup_s = time.perf_counter() - t_d
            # The exact and fuzzy passes' survivors, from what the semantic
            # pass embedded; then its rule in float64.
            pos, first_pass = 0, []
            for t in seen_in[0]:
                pos = dtexts.index(t, pos)
                first_pass.append(pos)
                pos += 1
            e64 = got_emb[0].astype(np.float64)
            e64 /= np.maximum(np.linalg.norm(e64, axis=1, keepdims=True),
                              1e-12)
            sim64 = e64 @ e64.T
            if not set(kept) <= set(first_pass):
                raise AssertionError("slice_components dedup kept a text "
                                     "the exact and fuzzy passes dropped")
            ties = int((np.abs(np.triu(sim64, 1) - dd.semantic_threshold)
                        <= THRESHOLD_TIE).sum())
            settled = hold_semantic_keep(
                [first_pass.index(i) for i in kept], sim64,
                dd.semantic_threshold)
            counts["dedup"] = {"threshold_ties": ties,
                               "decisions_settled_by_a_tie": settled}
            rep["consistency"] = {"sets": N_CONSISTENCY_SETS,
                                  "docs_per_set": SET_SIZE,
                                  "contradictions": n_contra,
                                  "check_host_ms": route_stats(ms_check),
                                  "pairwise_cosine_err": cos_err}
            rep["dedup"] = {"texts": len(dtexts),
                            "after_exact_fuzzy": len(first_pass),
                            "kept": len(kept), "seconds": dedup_s}

        # (e) Snapshots of the three indexes, loaded back onto the card.
        with timer.span("snapshots"):
            corpus = DenseIndex(DIM, capacity_block=CAPACITY_BLOCK,
                                tile=TILE, dtype=torch.float32, device=dev)
            corpus.add(corpus_rows)
            q_corpus = torch.from_numpy(svc.encode(first_q)).to(dev)
            arch_q = torch.from_numpy(np.stack(qe2)).to(dev)
            before = {}
            before["dense"] = drive("corpus_k2", lambda: [
                corpus.search(q_corpus[j:j + 1], 2)
                for j in range(q_corpus.shape[0])])
            before["arch"] = [mem.archival.search(arch_q[j:j + 1],
                                                  ARCHIVAL_K)
                              for j in range(arch_q.shape[0])]
            before["lex"] = [lex.search(t, 10) for t in lex_queries]
            t1 = time.perf_counter()
            for name, idx in (("archival", mem.archival),
                              ("dense", corpus), ("lexical", lex)):
                snapshot.save_state(work, name, idx.state_dict())
            save_s = time.perf_counter() - t1
            nbytes = sum(os.path.getsize(os.path.join(work, f))
                         for f in os.listdir(work))
            t1 = time.perf_counter()
            arch2 = DenseIndex.from_state_dict(
                snapshot.load_state(work, "archival"), device=dev)
            corpus2 = DenseIndex.from_state_dict(
                snapshot.load_state(work, "dense"), device=dev)
            lex2 = LexicalIndex.from_state_dict(
                snapshot.load_state(work, "lexical"), device=dev)
            lex2.build()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t1
            after = {}
            after["dense"] = drive("snapshot_corpus_k2", lambda: [
                corpus2.search(q_corpus[j:j + 1], 2)
                for j in range(q_corpus.shape[0])])
            after["arch"] = drive("snapshot_archival", lambda: [
                arch2.search(arch_q[j:j + 1], ARCHIVAL_K)
                for j in range(arch_q.shape[0])])
            after["lex"] = [lex2.search(t, 10) for t in lex_queries]
            for key in ("dense", "arch"):
                for j, (x, y) in enumerate(zip(before[key], after[key])):
                    if not (np.array_equal(x.ids, y.ids)
                            and np.array_equal(x.scores.view(np.int32),
                                               y.scores.view(np.int32))):
                        raise AssertionError(f"slice_components snapshot "
                                             f"{key} search {j} differs")
            for j, ((s1, i1), (s2, i2)) in enumerate(zip(before["lex"],
                                                         after["lex"])):
                if not (np.array_equal(i1, i2) and np.array_equal(
                        s1.view(np.int32), s2.view(np.int32))):
                    raise AssertionError(f"slice_components snapshot lexical"
                                         f" search {j} differs")
            routes = [r.route for r in after["dense"]]
            require_launched(paths, ("snapshot_corpus_k2",),
                             ("packed_extract", "extract"),
                             "restored corpus index k=2")
            require_launched(paths, ("snapshot_archival",), ("tile_topk",),
                             "restored archival index")
            rep["snapshots"] = {"save_seconds": save_s,
                                "load_seconds": load_s,
                                "bytes_on_disk": nbytes,
                                "corpus_rows": corpus2.size,
                                "archival_rows": arch2.size,
                                "lexical_docs": lex2.size,
                                "corpus_k2_routes": {r: routes.count(r)
                                                     for r in set(routes)}}
            del corpus, corpus2, lex2, before, after

        # (f) The index policy, the health probe and a device trace.
        with timer.span("policy_health_trace"):
            if select_index_kind(N_HYBRID, 1) != "dense":
                raise AssertionError("select_index_kind(262,144, 1) is not "
                                     "dense")
            built = build_index_for("dense", DIM, Settings())
            if built.device.type != "cuda":
                raise AssertionError(f"build_index_for on {built.device}")
            del built
            health = check_device_health()
            if not (health["healthy"] and health["backend"] == "cuda"
                    and health["device_count"] == 1):
                raise AssertionError(f"check_device_health: {health}")
            trace_dir = os.path.join(work, "trace")
            with device_trace(trace_dir):
                drive("trace_archival", lambda: [
                    arch2.search(arch_q[j:j + 1], ARCHIVAL_K)
                    for j in range(16)])
            with open(os.path.join(trace_dir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            # One K6 kernel event per launch (the profiler may drop the one
            # at the window's edge).
            k6 = [e for e in events if e.get("cat") == "kernel"
                  and "stream_topk_kernel" in e.get("name", "")]
            launched = paths["trace_archival"]["tile_topk"]
            if not max(1, launched - 1) <= len(k6) <= launched:
                raise AssertionError(f"the trace names K6's kernel "
                                     f"{len(k6)} times for {launched} "
                                     "launches")
            rep["health"] = health
            rep["trace"] = {"events": len(events), "k6_kernels": len(k6),
                            "k6_launches": launched,
                            "k6_kernel_name": k6[0]["name"][:120]}
        held = hold_recorded(K_, T_, {p: log[p] for p in
                                      COMPONENT_KERNEL_PATHS}, 5,
                             "slice_components")
        emit({"phase": "slice_components", "card": smi, **rep,
              "stages_host": timer.stats(),
              "allowed_differences": counts, "launches_by_path": paths,
              "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - t0})
        for rec in held:
            emit({"phase": "slice_components", "card": smi,
                  "kernel": rec["name"],
                  **{key: v for key, v in rec.items() if key != "name"}})
        del mem, arch2, lex, store
        return held
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------- slice_agent

# The reference's turn probe (bench.py:640-683): 128 synthetic documents of
# 10 topics ingested in groups of 64, 4 warm-up turns, 16 timed turns.
AGENT_DOCS, AGENT_TOPICS, AGENT_SEED = 128, 10, 11
AGENT_GROUP, AGENT_WARMUP, AGENT_TURNS = 64, 4, 16
AGENT_REPLAY_TURNS = 8            # timed turns the CPU replays
AGENT_CLOCK = 1_790_000_000.0     # time.time() in the phase, both runs
FUSED_TIE = 1e-4                  # fused scores after an encoder forward
# One session over the qa_docs: each intent the deterministic LLM gives,
# the KG's two-hop chain, a question about the session itself and one no
# document answers.
QA_SESSION = (
    ("What is the default chunk size and overlap?", "question_answering"),
    ("Compare brute-force search and IVF indexes", "comparison"),
    ("Summarize the three kinds of agent memory", "summarization"),
    ("Is it true that an answer whose factuality score falls below 0.50 "
     "is refused?", "fact_checking"),
    ("Who led the Meridian project and then where did they come from?",
     "multi_hop_reasoning"),
    ("What did I ask earlier?", "clarification"),
    ("What did the framework's cloud bill cost in March?",
     "question_answering"),
    ("What are the BM25 defaults for k1 and b?", "question_answering"))
QA_MULTI_HOP, QA_REFUSAL = 4, 6
AGENT_KERNEL_PATHS = ("agent_probe", "agent_qa", "agent_archival")
TURN_FIELDS = ("trace", "intent", "refused", "sources", "citations",
               "answer")


def make_agent(dev, data_dir):
    """``RAGAgent`` from ``Settings()`` defaults on ``dev``: the pretrained
    encoders that ``find_checkpoint_dir`` finds, the deterministic LLM and
    an offline web tool that finds nothing."""
    from optimized_rag_tpu_torch.agent.agent import RAGAgent
    from optimized_rag_tpu_torch.agent.llm import DeterministicLLM
    from optimized_rag_tpu_torch.agent.web import WebSearchTool
    from optimized_rag_tpu_torch.config import Settings
    settings = Settings()
    settings.data_dir = data_dir
    return RAGAgent(settings, llm=DeterministicLLM(),
                    web=WebSearchTool(search_fn=lambda q, n: []), device=dev)


def turn(agent, text):
    """One chat turn: its fields and host-clock ms."""
    trace = []
    t0 = time.perf_counter()
    resp = agent.chat(text, trace=trace)
    ms = (time.perf_counter() - t0) * 1e3
    if not resp.answer:
        raise AssertionError(f"slice_agent: empty answer to {text!r}")
    return {"trace": trace, "intent": resp.intent, "refused": resp.refused,
            "sources": [s["doc_id"] for s in resp.sources],
            "citations": resp.citations, "answer": resp.answer,
            "tiers_used": resp.tiers_used, "ms": ms}


def ingest_probe(agent, ds):
    for i in range(0, len(ds.texts), AGENT_GROUP):
        agent.ingestor.ingest_text("\n".join(ds.texts[i:i + AGENT_GROUP]),
                                   filename=f"doc{i}.txt")


class TieLog:
    """The near-ties a CPU run's turn shows, by kind: a cosine within
    THRESHOLD_TIE of a verification threshold (the rewriter's and the
    verifiers' cosines), two cross-encoder logits of one forward within
    LOGIT_ATOL, two fused scores of one retrieval within FUSED_TIE."""

    def __init__(self, agent):
        from optimized_rag_tpu_torch.agent import rewriter, verification
        s = agent.settings
        self.thresholds = np.asarray(
            [s.verification.embedding_verify_threshold, 0.75, 0.85, 0.0])
        self.kinds = Counter()
        self._mods = (rewriter, verification)
        self._cosine = verification.cosine_matrix
        self._agent = agent
        self._retrieve = agent.retriever.retrieve

    def __enter__(self):
        def cosine(a, b):
            out = self._cosine(a, b)
            v = out.double().cpu().numpy().reshape(-1, 1)
            if (np.abs(v - self.thresholds) <= THRESHOLD_TIE).any():
                self.kinds["threshold"] += 1
            return out

        def logits(module, args, out):
            live = args[1].sum(dim=1) > 0           # rows with tokens
            self._pairs("logit", out.float()[live].cpu().numpy(), LOGIT_ATOL)

        def retrieve(*args, **kw):
            docs = self._retrieve(*args, **kw)
            self._pairs("fused", np.asarray([d.score for d in docs]),
                        FUSED_TIE)
            return docs
        for mod in self._mods:
            mod.cosine_matrix = cosine
        self._hook = self._agent.cross_encoder.model.register_forward_hook(
            logits)
        self._agent.retriever.retrieve = retrieve
        return self

    def _pairs(self, kind, v, tol):
        v = np.sort(v.astype(np.float64))
        if len(v) > 1 and np.diff(v).min() <= tol:
            self.kinds[kind] += 1

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.cosine_matrix = self._cosine
        self._hook.remove()
        del self._agent.retriever.retrieve


def turn_differs(card, cpu):
    """The first of TURN_FIELDS where two turns differ, or None."""
    return next((f for f in TURN_FIELDS if cpu[f] != card[f]), None)


def replay(what, card_turns, cpu_agent, texts, counts, phase="slice_agent",
           ask=None, differ=turn_differs, tie_log=TieLog, independent=False):
    """``texts`` through ``cpu_agent`` in order (``ask(text)``, by default
    one ``turn``), each answer held against the card's: ``differ(card,
    cpu)`` finds no difference, or the first one it finds shows a near-tie
    in the CPU run (counted by kind). After an excused difference the
    histories differ: later turns are counted, not held, unless the turns
    are ``independent`` (no turn sees another's history)."""
    ask = ask or (lambda text: turn(cpu_agent, text))
    log = counts.setdefault(what, {"equal": 0, "excused": [],
                                   "after_divergence": 0,
                                   "ties_in_equal_turns": Counter()})
    diverged = False
    for j, (text, card) in enumerate(zip(texts, card_turns)):
        with tie_log(cpu_agent) as ties:
            cpu = ask(text)
        if diverged:
            log["after_divergence"] += 1
            continue
        where = differ(card, cpu)
        if where is None:
            log["equal"] += 1
            log["ties_in_equal_turns"].update(ties.kinds)
            continue
        shown = [str(x.get(where, x))[:300] for x in (card, cpu)]
        if not ties.kinds:
            raise AssertionError(
                f"{phase} {what} turn {j} ({text!r}): {where} on the card "
                f"{shown[0]}, on the CPU {shown[1]}, and the CPU run shows "
                "no near-tie")
        log["excused"].append({"turn": j, "field": where,
                               "ties": dict(ties.kinds), "card": shown[0],
                               "cpu": shown[1]})
        diverged = not independent


def phase_slice_agent(K_, T_, dev, chunks, smi):
    """The agent and one chat turn on the card: RAGAgent (Settings()
    defaults, the pretrained encoders, the deterministic LLM, an offline
    web tool) runs the whole 16-node graph. (a) The reference's turn probe:
    make_dataset(128 docs, 10 topics, seed 11) ingested in groups of 64,
    warmup(), 4 warm-up turns, 16 timed turns (host p50/p99, per-node
    spans, the device's busy and idle share under torch.profiler, kernel
    launches per turn). (b) A fresh agent uploads the qa_docs and answers
    a session of 8 questions (every intent, the KG's two-hop chain, a
    recall question, a refusal). (c) The agent of (a) after a year of
    archival notes (65,536 through bulk_insert_archival): 16 more turns,
    each launching K6 over the notes, each turn's archival hits held
    against a float64 oracle. A CPU agent built the same way replays (b)
    and (a) up to its 8th timed turn, turn by turn against the card.
    ``time.time`` is pinned for the phase. Resets the peak memory
    statistics. Returns the kernel records of its paths."""
    import shutil
    import tempfile
    from optimized_rag_tpu_torch.eval.synthetic import make_dataset
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.mkdtemp(prefix="slice_agent-",
                            dir=os.path.join(HERE, "build"))
    paths, log, counts, rep = {}, {}, {}, {}
    clock = time.time
    time.time = lambda: AGENT_CLOCK
    qa_dir = QA_DOCS

    def drive(name, agent, texts):
        """Each text as one turn, launch counts from 0 and every kernel
        call recorded (the recorded calls must equal the counts); each
        turn's launches beside its tiers."""
        calls = log.setdefault(name, [])
        turns = []
        with recording(T_, K_, calls):
            K_.reset_launch_counts()
            for text in texts:
                before = K_.launch_counts()
                turns.append(turn(agent, text))
                after = K_.launch_counts()
                turns[-1]["launches"] = {
                    k: after[k] - before[k] for k in after
                    if after[k] - before[k]}
            paths[name] = K_.launch_counts()
        seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if seen != paths[name]:
            raise AssertionError(f"slice_agent {name}: recorded {seen}, "
                                 f"counted {paths[name]}")
        return turns

    def summary(turns):
        return {**route_stats([t["ms"] for t in turns]),
                "turns": [{k: t[k] for k in ("intent", "tiers_used",
                                             "launches", "refused", "ms")}
                          for t in turns]}

    try:
        # (a) The reference's turn probe.
        ds = make_dataset(num_docs=AGENT_DOCS, num_topics=AGENT_TOPICS,
                          num_queries=AGENT_WARMUP + AGENT_TURNS,
                          seed=AGENT_SEED)
        agent = make_agent(dev, os.path.join(work, "probe"))
        t1 = time.perf_counter()
        ingest_probe(agent, ds)
        torch.cuda.synchronize()
        rep["ingest_seconds"] = time.perf_counter() - t1
        rep["probe_rows"] = agent.dense.size
        t1 = time.perf_counter()
        agent.warmup()
        torch.cuda.synchronize()
        rep["warmup_seconds"] = time.perf_counter() - t1
        warm = [turn(agent, q) for q in ds.queries[:AGENT_WARMUP]]
        agent.timer.reset()
        timed = []
        busy = device_busy(lambda: timed.extend(drive(
            "agent_probe", agent, ds.queries[AGENT_WARMUP:])), cpu=False)
        if not busy["device_busy_ms"]:
            raise AssertionError("slice_agent: the profiler saw no device "
                                 "time over the timed turns")
        if not sum(paths["agent_probe"].values()):
            raise AssertionError("slice_agent: the 16 timed turns launched "
                                 "no kernel")
        # Each of the graph's 16 nodes: its p50 span and how often it ran
        # (a node no timed turn reached has no span).
        spans = agent.timer.stats()
        rep["probe"] = {**summary(timed), "device": busy, "nodes": {
            name: {"p50_ms": spans[name]["p50_ms"],
                   "count": spans[name]["count"]} if name in spans else None
            for name in agent.graph.spec._nodes}}
        if len(rep["probe"]["nodes"]) != 16 or set(spans) - set(
                rep["probe"]["nodes"]):
            raise AssertionError(f"slice_agent: node spans {sorted(spans)}")

        # (c) The same agent after a year of archival notes.
        notes = filler_texts(chunks, N_ARCHIVAL, SEED + 23)
        t1 = time.perf_counter()
        for lo in range(0, N_ARCHIVAL, ARCHIVAL_BATCH):
            agent.memory.bulk_insert_archival(notes[lo:lo + ARCHIVAL_BATCH])
        torch.cuda.synchronize()
        rep["archival_insert_rows_per_s"] = N_ARCHIVAL / (
            time.perf_counter() - t1)
        if agent.memory.archival.size != N_ARCHIVAL:
            raise AssertionError(f"archival rows {agent.memory.archival.size}")
        hits = []
        search = agent.memory.archival_memory_search

        def archival_search(query, top_k=5):
            """The search, and the query embedding it used (the encoder's
            cache holds it until a later stage may overwrite it)."""
            docs = search(query, top_k)
            hits.append((agent.embedder.encode([query])[0],
                         ([d.doc_id for d in docs], [d.score for d in docs])))
            return docs
        agent.memory.archival_memory_search = archival_search
        later = make_dataset(num_docs=AGENT_DOCS, num_topics=AGENT_TOPICS,
                             num_queries=AGENT_TURNS, seed=AGENT_SEED + 1)
        archival = drive("agent_archival", agent, later.queries)
        del agent.memory.archival_memory_search
        if len(hits) != AGENT_TURNS:
            raise AssertionError(f"slice_agent: {len(hits)} archival "
                                 f"searches in {AGENT_TURNS} turns")
        idle = [j for j, t in enumerate(archival)
                if not t["launches"].get("tile_topk")]
        if idle:
            raise AssertionError(f"slice_agent: turns {idle} of (c) launched "
                                 "no K6")
        rows64 = agent.memory.archival.embeddings()[:N_ARCHIVAL] \
            .cpu().numpy().astype(np.float64)
        counts["archival"] = {"near_tie": 0}
        err = max(hold_archival(f"slice_agent archival turn {j}", got,
                                rows64, q, counts["archival"])
                  for j, (q, got) in enumerate(hits))
        rep["archival"] = {**summary(archival), "oracle_max_err": err,
                           "k6_launches": paths["agent_archival"][
                               "tile_topk"]}
        del agent, rows64

        # (b) A chat session over the qa_docs.
        qa_agent = make_agent(dev, os.path.join(work, "qa"))
        t1 = time.perf_counter()
        uploads = qa_agent.ingestor.upload_directory(qa_dir)
        rep["qa_upload_seconds"] = time.perf_counter() - t1
        if not all(u["ok"] for u in uploads):
            raise AssertionError(f"slice_agent: upload {uploads}")
        qa = drive("agent_qa", qa_agent, [q for q, _ in QA_SESSION])
        got = [t["intent"] for t in qa]
        if got != [i for _, i in QA_SESSION]:
            raise AssertionError(f"slice_agent: intents {got}")
        hop, refusal = qa[QA_MULTI_HOP], qa[QA_REFUSAL]
        if -2 not in hop["sources"] or "basel" not in hop["answer"].lower():
            raise AssertionError(f"slice_agent: the two-hop question: {hop}")
        if not refusal["refused"] or any(
                t["refused"] for j, t in enumerate(qa) if j != QA_REFUSAL):
            raise AssertionError(f"slice_agent: refusals "
                                 f"{[t['refused'] for t in qa]}")
        rep["qa_session"] = [{k: t[k] for k in (
            "intent", "trace", "refused", "citations", "sources", "tiers_used",
            "launches", "ms")} for t in qa]
        del qa_agent

        # The CPU replays: (b)'s session, then (a) up to its 8th timed turn.
        cpu = torch.device("cpu")
        t1 = time.perf_counter()
        cpu_qa = make_agent(cpu, os.path.join(work, "cpu_qa"))
        cpu_qa.ingestor.upload_directory(qa_dir)
        replay("agent_qa", qa, cpu_qa, [q for q, _ in QA_SESSION], counts)
        del cpu_qa
        cpu_probe = make_agent(cpu, os.path.join(work, "cpu_probe"))
        ingest_probe(cpu_probe, ds)
        cpu_probe.warmup()
        n = AGENT_WARMUP + AGENT_REPLAY_TURNS
        replay("agent_probe", warm + timed, cpu_probe, ds.queries[:n],
               counts)
        del cpu_probe
        rep["cpu_replay_seconds"] = time.perf_counter() - t1

        held = hold_recorded(K_, T_, {p: log[p] for p in AGENT_KERNEL_PATHS},
                             5, "slice_agent")
        emit({"phase": "slice_agent", "card": smi, **rep,
              "allowed_differences": counts, "launches_by_path": paths,
              "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - t0})
        for rec in held:
            emit({"phase": "slice_agent", "card": smi, "kernel": rec["name"],
                  **{key: v for key, v in rec.items() if key != "name"}})
        return held
    finally:
        time.time = clock
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()


# --------------------------------------------------- the entry points, IVF

N_SERVE = 65_536                  # chunks of the served corpus: one block
SERVE_FILE_FILLERS = 4_096        # filler texts a file (about 1,020 chunks)
N_SERVE_WARM = 256                # warm-up requests, as bench.py:713-719
N_SERVE_BURSTS, SERVE_BURST = 256, 8
SERVE_LOOP_S = 5.0                # the closed loop, as bench.py:741
SERVE_WAIT_S = 240                # the CLI server's start-up, at most
CLI_QUESTIONS = (QA_SESSION[0][0], QA_SESSION[2][0], QA_SESSION[7][0])
N_CONCURRENT_CHATS = 4
FLOAT_TOL = LOGIT_ATOL / 4        # a reply's float after the cross-encoder
SERVE_KERNEL_PATHS = ("serve_search", "serve_chat")
CHAT_FIELDS = {"answer", "citations", "sources", "confidence",
               "factuality_score", "support_ratio", "refused", "intent",
               "tiers_used", "warnings", "metrics"}
FRESH_TEXT = ("Zebra quagga okapi: the fresh field notes name three striped "
              "animals that no earlier document of the corpus mentions.")


class CliProcess:
    """``python -m optimized_rag_tpu_torch ARGS`` started from the repo root,
    ``stdin`` fed from a file, its output in files under ``work``."""

    def __init__(self, work, name, args, env, stdin=""):
        self.name, self.seconds = name, None
        self.files = [open(os.path.join(work, f"{name}.{n}"), "w+",
                           encoding="utf-8") for n in ("in", "out", "err")]
        self.files[0].write(stdin)
        self.files[0].seek(0)
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "optimized_rag_tpu_torch", *args],
            cwd=HERE, env=env, stdin=self.files[0], stdout=self.files[1],
            stderr=self.files[2], text=True)

    def wait(self, timeout):
        """Its stdout once it exits; a non-zero exit raises with the tail of
        its stderr, and a timeout kills it."""
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        self.seconds = time.perf_counter() - self.t0
        out, err = (self._read(j) for j in (1, 2))
        self.close()
        if rc:
            raise RuntimeError(f"cli {self.name} exited {rc}: {err[-3000:]}")
        return out

    def _read(self, j):
        self.files[j].seek(0)
        return self.files[j].read()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)

    def close(self):
        for f in self.files:
            f.close()


def http(port, path, payload=None, timeout=120):
    """(status, JSON) of a GET (``payload`` None) or a POST."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_fillers(words, n, seed):
    """``n`` seeded FILLER_WORDS-word texts of ``words`` (a numpy array),
    slice_hybrid's fillers drawn by numpy."""
    idx = np.random.default_rng(seed).integers(0, len(words),
                                               (n, FILLER_WORDS))
    return [" ".join(ws) for ws in words[idx].tolist()]


def serve_corpus(chunks, docs_dir, settings):
    """The qa_docs and seeded filler files (FILLER_WORDS-word texts of the
    chunks' own words, blank-line separated) in ``docs_dir``, so that the
    agent's ingest of the directory makes exactly N_SERVE chunks: each file
    is counted with the ingestor's cleaner (which leaves filler text as it
    is: checked on the first) and chunker, and the last filler file is cut
    to the count still missing. Returns the file names."""
    from optimized_rag_tpu_torch.engine.chunking import RecursiveChunker
    from optimized_rag_tpu_torch.engine.wrangler import TextCleaner
    c = settings.chunking
    if c.strategy != "recursive":
        raise AssertionError(f"chunking strategy {c.strategy!r}")
    cleaner, chunker = TextCleaner(), RecursiveChunker(c.chunk_size,
                                                       c.chunk_overlap)

    def count(text, clean=True):
        got = chunker.chunk(cleaner.clean(text) if clean else text,
                            {"document_id": 0})
        return sum(len(x["content"].strip()) >= c.min_chunk_chars
                   for x in got) or 1

    total, names = 0, []
    qa_dir = QA_DOCS
    for path in sorted(glob.glob(os.path.join(qa_dir, "*.md"))):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        names.append(os.path.basename(path))
        with open(os.path.join(docs_dir, names[-1]), "w",
                  encoding="utf-8") as f:
            f.write(text)
        total += count(text)
    words = np.array([w for ch in chunks for w in ch.split()], object)
    j = 0
    while total < N_SERVE:
        texts = serve_fillers(words, SERVE_FILE_FILLERS, SEED + 100 + j)
        text = "\n\n".join(texts)
        if j == 0 and cleaner.clean(text) != text:
            raise AssertionError("the cleaner changes the filler text")
        need = N_SERVE - total
        if count(text, clean=False) > need:
            lo, hi = 1, len(texts)      # fewest fillers making >= need
            while lo < hi:
                mid = (lo + hi) // 2
                if count("\n\n".join(texts[:mid]), clean=False) >= need:
                    hi = mid
                else:
                    lo = mid + 1
            text = "\n\n".join(texts[:lo])
        names.append(f"filler_{j:03d}.txt")
        with open(os.path.join(docs_dir, names[-1]), "w",
                  encoding="utf-8") as f:
            f.write(text)
        total += count(text, clean=False)
        j += 1
    if total != N_SERVE:
        raise AssertionError(f"the corpus plan makes {total} chunks")
    return names


def json_split(obj, path=""):
    """(the JSON value without floats and ``latency_s``, {path: float})."""
    if isinstance(obj, dict):
        out, nums = {}, {}
        for k, v in obj.items():
            if k != "latency_s":
                out[k], sub = json_split(v, f"{path}.{k}")
                nums.update(sub)
        return out, nums
    if isinstance(obj, list):
        out, nums = [], {}
        for j, v in enumerate(obj):
            e, sub = json_split(v, f"{path}[{j}]")
            out.append(e)
            nums.update(sub)
        return out, nums
    if isinstance(obj, float):
        return "<float>", {path: obj}
    return obj, {}


def replies_differ(a, b):
    """The first path where two /chat replies differ: every value but the
    floats equal, floats within FLOAT_TOL; None if they agree."""
    (ea, na), (eb, nb) = json_split(a), json_split(b)
    if ea != eb:
        return next((k for k in ea if ea.get(k) != eb.get(k)), "keys")
    return next((k for k in na if not abs(na[k] - nb[k]) <= FLOAT_TOL), None)


def hold_served(what, got, qvecs, rows64, counts, k=K):
    """/search answers (lists of {doc_id, score}) against the float64 top-k
    over ``rows64`` [N, D] (on the card) for the query vectors the server
    embedded: ids equal unless the oracle shows a near-tie of TIE_TOL
    (counted), scores within TIE_TOL. Returns the worst score error."""
    err = 0.0
    for lo in range(0, len(got), 256):
        q = torch.from_numpy(np.stack(qvecs[lo:lo + 256])).to(
            rows64.device, torch.float64)
        s = q @ rows64.T
        o_s, o_i = torch.sort(s, dim=1, descending=True, stable=True)
        o_s, o_i = o_s[:, :k].cpu().numpy(), o_i[:, :k].cpu().numpy()
        for j, res in enumerate(got[lo:lo + 256]):
            ids = np.array([r["doc_id"] for r in res], np.int64)
            vals = np.array([r["score"] for r in res], np.float64)
            if len(ids) != k:
                raise AssertionError(f"{what} {lo + j}: {len(ids)} results")
            if (ids != o_i[j]).any():
                mine = s[j, torch.from_numpy(ids).to(s.device)].cpu().numpy()
                if np.abs(mine - o_s[j]).max() > TIE_TOL:
                    raise AssertionError(
                        f"{what} {lo + j}: ids {ids.tolist()} differ from the "
                        f"oracle's {o_i[j].tolist()}")
                counts["near_tie"] += 1
            err = max(err, float(np.abs(vals - o_s[j]).max()))
        del s
    if not err <= TIE_TOL:
        raise AssertionError(f"{what}: scores off by {err:.3g}")
    return err


def http_load(port, texts, burst, seconds=None):
    """/search requests for ``texts`` (k=K) from N_CLIENTS threads: each
    client sends ``burst`` at a time and waits for them; with ``seconds``
    each client instead loops one at a time until then, cycling through
    its texts. Returns [(text, results)], latencies (ms) and wall seconds."""
    from concurrent.futures import ThreadPoolExecutor
    out, lat, errors = [], [], []
    lock = threading.Lock()

    def one(text):
        t0 = time.perf_counter()
        code, body = http(port, "/search", {"query": text, "k": K})
        ms = (time.perf_counter() - t0) * 1e3
        if code != 200:
            raise AssertionError(f"/search {text!r}: {code} {body}")
        with lock:
            out.append((text, body["results"]))
            lat.append(ms)

    def client(c, pool):
        try:
            mine = texts[c::N_CLIENTS]
            if seconds is not None:
                stop, j = time.perf_counter() + seconds, 0
                while time.perf_counter() < stop:
                    one(f"{mine[j % len(mine)]} ({j // len(mine)})")
                    j += 1
                return
            for j in range(0, len(mine), burst):
                for f in [pool.submit(one, t) for t in mine[j:j + burst]]:
                    f.result(timeout=120)
        except BaseException as exc:          # reported by the caller
            errors.append(exc)

    with ThreadPoolExecutor(N_CLIENTS * burst) as pool:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c, pool),
                                    daemon=True) for c in range(N_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in clients):
        raise RuntimeError("/search clients still alive")
    return out, lat, wall


def load_stats(lat, wall):
    lat = sorted(lat)
    return {"requests": len(lat), "qps": len(lat) / wall,
            "p50_ms": statistics.median(lat),
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "wall_s": wall}


def serving_agent(data_dir, dev, concurrent=False):
    """``cli.build_agent`` over ``data_dir`` (the snapshot there) on
    ``dev``, as ``serve`` builds it."""
    from optimized_rag_tpu_torch import cli
    from optimized_rag_tpu_torch.config import Settings
    settings = Settings.from_env()
    settings.data_dir = data_dir
    settings.serving.concurrent_chat = concurrent
    return cli.build_agent(settings, device=dev)


def phase_slice_serve(K_, T_, dev, chunks, queries, work, smi):
    """The entry points as a user runs them. (1) A data directory and a
    directory of the qa_docs and seeded filler files making 65,536 chunks.
    (2) ``python -m optimized_rag_tpu_torch`` in subprocesses: ``info``,
    ``ingest`` of the directory, ``chat`` (three questions, ``memory``,
    ``stats``), ``serve`` (/healthz, /stats, 8 /search, 2 /chat, then
    SIGINT). (3) In process, ``cli.build_agent(device="cuda")`` over the
    snapshot behind ``AgentHTTPServer``: 256 warm-up /search requests,
    256 in bursts of 8 from 8 clients, a closed loop of 5 s (k=10), every
    answer held against the float64 oracle over the snapshot's rows; the 8
    questions of slice_agent (b) over /chat, replayed through a CPU agent
    over a copy of the data directory behind its own server (each reply
    equal, near-ties excused and counted); then 4 concurrent /chat clients
    with ``concurrent_chat``. ``time.time`` is pinned from (3) on. Its files
    go under ``work`` (the data directory ``work/data`` is slice_ivf's;
    the caller removes ``work``). Returns the kernel records of /search and
    /chat."""
    import shutil
    import signal
    from optimized_rag_tpu_torch.config import Settings
    from optimized_rag_tpu_torch.server import AgentHTTPServer
    t0 = time.perf_counter()
    data, docs = os.path.join(work, "data"), os.path.join(work, "docs")
    os.makedirs(docs)
    env = dict(os.environ, ORAG_DATA_DIR=data)
    rep, paths, log, counts = {}, {}, {}, {"near_tie": 0}

    # (2) The CLI in subprocesses: info beside the corpus plan, then
    # ingest, then chat beside serve.
    procs = []
    try:
        info = CliProcess(work, "info", ["info"], env)
        procs.append(info)
        names = serve_corpus(chunks, docs, Settings())
        rep["files"] = len(names)
        rep["plan_seconds"] = time.perf_counter() - t0
        out = info.wait(SERVE_WAIT_S)
        if torch.cuda.get_device_name(0) not in out or \
                "'healthy': True" not in out or "backend: cuda" not in out:
            raise AssertionError(f"slice_serve info: {out}")
        ingest = CliProcess(work, "ingest", ["ingest", docs], env)
        procs.append(ingest)
        out = ingest.wait(900).splitlines()
        oks = [line for line in out if line.startswith("ok  ")]
        want_total = (f"total: {N_SERVE} chunks; corpus size {N_SERVE}; "
                      f"index snapshot -> {os.path.join(data, 'indexes')}")
        if len(oks) != len(names) or out[-1] != want_total:
            raise AssertionError(f"slice_serve ingest: {len(oks)} ok of "
                                 f"{len(names)} files; last line "
                                 f"{out[-1]!r}")
        chat = CliProcess(work, "chat", ["chat"], env, stdin="\n".join(
            [*CLI_QUESTIONS, "memory", "stats", "exit"]) + "\n")
        port = free_port()
        serve = CliProcess(work, "serve", ["serve", "--port", str(port)],
                           env)
        procs += [chat, serve]
        while True:
            if serve.proc.poll() is not None:
                serve.wait(0)                   # raises with its stderr
            try:
                code, health = http(port, "/healthz", timeout=5)
                break
            except OSError:
                if time.perf_counter() - serve.t0 > SERVE_WAIT_S:
                    raise
                time.sleep(0.5)
        rep["serve_start_seconds"] = time.perf_counter() - serve.t0
        if (code, health) != (200, {"ok": True, "backend": "cuda",
                                    "corpus_size": N_SERVE}):
            raise AssertionError(f"slice_serve /healthz: {code} {health}")
        code, stats = http(port, "/stats")
        if code != 200 or stats["corpus_size"] != N_SERVE:
            raise AssertionError(f"slice_serve /stats: {code} {stats}")
        for text in queries[0][:8]:
            code, body = http(port, "/search", {"query": text, "k": K})
            if code != 200 or len(body["results"]) != K:
                raise AssertionError(f"slice_serve /search: {code} {body}")
        for text in CLI_QUESTIONS[:2]:
            code, body = http(port, "/chat", {"message": text})
            if code != 200 or set(body) != CHAT_FIELDS or not body["answer"]:
                raise AssertionError(f"slice_serve /chat: {code} {body}")
        serve.proc.send_signal(signal.SIGINT)
        printed = serve.wait(60).splitlines()
        if printed[:1] != [f"serving on http://127.0.0.1:{port} (corpus: "
                           f"{N_SERVE} chunks)"]:
            raise AssertionError(f"slice_serve serve printed {printed[:1]}")
        out = chat.wait(SERVE_WAIT_S)
        if out.count("Assistant:") != len(CLI_QUESTIONS) or \
                "<persona>" not in out or "rerank:" not in out:
            raise AssertionError(f"slice_serve chat: {out[-2000:]}")
    finally:
        for p in procs:
            p.kill()
            p.close()
    for p in procs:
        rep[f"{p.name}_seconds"] = p.seconds
    rep["cli_seconds"] = time.perf_counter() - t0

    # (3) In process: the held and timed load.
    cpu_data = os.path.join(work, "data_cpu")
    shutil.copytree(data, cpu_data)
    clock = time.time
    now = clock()
    time.time = lambda: now
    servers = []
    try:
        t1 = time.perf_counter()
        agent = serving_agent(data, dev)
        agent.warmup()
        torch.cuda.synchronize()
        rep["agent_load_seconds"] = time.perf_counter() - t1
        if agent.dense.size != N_SERVE:
            raise AssertionError(f"slice_serve: {agent.dense.size} rows")
        seen = {}
        embed = agent.embed_fn

        def embed_fn(texts):
            """The agent's encoder, each text's vector kept for the
            oracle."""
            out = embed(texts)
            seen.update(zip(texts, out))
            return out
        agent.embed_fn = embed_fn
        store_text, text_s = agent.store.chunk_text, Counter()
        text_lock = threading.Lock()

        def chunk_text(i):
            """The store's lookup, its host seconds summed over threads."""
            t = time.perf_counter()
            out = store_text(i)
            with text_lock:
                text_s["s"] += time.perf_counter() - t
            return out
        agent.store.chunk_text = chunk_text
        srv = AgentHTTPServer(agent, port=0)
        servers.append(srv)
        port = srv.start()
        warm = [f"warm storm {i}" for i in range(N_SERVE_WARM)]
        http_load(port, warm, SERVE_BURST)
        rows64 = agent.dense.embeddings()[:N_SERVE].double()
        got, conns, text_s["s"] = {}, len(agent.store._conns), 0.0
        with recording(T_, K_, log.setdefault("serve_search", [])):
            K_.reset_launch_counts()
            got["bursts"] = http_load(port, queries[0][:N_SERVE_BURSTS],
                                      SERVE_BURST)
            busy = device_busy(lambda: got.__setitem__(
                "closed_loop", http_load(port, queries[1], 1,
                                         seconds=SERVE_LOOP_S)), cpu=False)
            paths["serve_search"] = K_.launch_counts()
        del agent.store.chunk_text
        rep["search"] = {
            "stats": srv.query_server.get_stats(),
            "closed_loop_device": busy,
            "chunk_text_host_s": text_s["s"],
            "store_connections_opened": len(agent.store._conns) - conns}
        for name, (answers, lat, wall) in got.items():
            rep["search"][name] = {
                **load_stats(lat, wall), "oracle_max_err": hold_served(
                    f"slice_serve /search {name}", [a for _, a in answers],
                    [seen[t] for t, _ in answers], rows64, counts)}
        del rows64, got
        agent.embed_fn = embed
        texts = [q for q, _ in QA_SESSION]
        card = []
        with recording(T_, K_, log.setdefault("serve_chat", [])):
            K_.reset_launch_counts()
            for text in texts:
                t1 = time.perf_counter()
                code, body = http(port, "/chat", {"message": text})
                card.append(body)
                if code != 200 or set(body) != CHAT_FIELDS:
                    raise AssertionError(f"slice_serve /chat {text!r}: "
                                         f"{code} {body}")
                body["_ms"] = (time.perf_counter() - t1) * 1e3
            paths["serve_chat"] = K_.launch_counts()
        rep["chat"] = route_stats([b.pop("_ms") for b in card])
        for name in SERVE_KERNEL_PATHS:
            seen_calls = {m: sum(c == m for c, _ in log[name])
                          for m in K_.KERNELS}
            if seen_calls != paths[name]:
                raise AssertionError(f"slice_serve {name}: recorded "
                                     f"{seen_calls}, counted {paths[name]}")
            if not paths[name]["tile_topk"]:
                raise AssertionError(f"slice_serve {name}: no K6 launch")
        srv.stop()
        servers.remove(srv)
        del agent, srv
        torch.cuda.empty_cache()

        # The CPU replay of the /chat turns.
        t1 = time.perf_counter()
        cpu_agent = serving_agent(cpu_data, "cpu")
        cpu_agent.warmup()
        cpu_srv = AgentHTTPServer(cpu_agent, port=0)
        servers.append(cpu_srv)
        cpu_port = cpu_srv.start()

        def ask(text):
            code, reply = http(cpu_port, "/chat", {"message": text})
            if code != 200:
                raise AssertionError(f"slice_serve CPU /chat: {code} {reply}")
            return reply
        replay("serve_chat", card, cpu_agent, texts, counts,
               phase="slice_serve", ask=ask, differ=replies_differ)
        cpu_srv.stop()
        servers.remove(cpu_srv)
        del cpu_agent, cpu_srv
        rep["cpu_replay_seconds"] = time.perf_counter() - t1

        # Concurrent /chat turns, their embeddings coalesced.
        agent = serving_agent(data, dev, concurrent=True)
        agent.warmup()
        srv = AgentHTTPServer(agent, port=0)
        servers.append(srv)
        port = srv.start()
        before = dict(agent.embed_batcher.stats)
        replies = [None] * N_CONCURRENT_CHATS

        def chat(c):
            replies[c] = http(port, "/chat", {"message": CLI_QUESTIONS[
                c % len(CLI_QUESTIONS)] + f" ({c})"})
        t1 = time.perf_counter()
        clients = [threading.Thread(target=chat, args=(c,), daemon=True)
                   for c in range(N_CONCURRENT_CHATS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t1
        stats = {k: agent.embed_batcher.stats[k] - before.get(k, 0)
                 for k in ("dispatches", "requests", "texts")}
        bad = [r for r in replies if r is None or r[0] != 200
               or set(r[1]) != CHAT_FIELDS or not r[1]["answer"]]
        if bad or stats["dispatches"] >= stats["requests"]:
            raise AssertionError(f"slice_serve concurrent /chat: {bad}; "
                                 f"batcher {stats}")
        rep["concurrent_chat"] = {"clients": N_CONCURRENT_CHATS,
                                  "wall_s": wall, "batcher": stats,
                                  "max_coalesced": agent.embed_batcher.stats[
                                      "max_coalesced"]}
        srv.stop()
        servers.remove(srv)
        agent.embed_batcher.stop()
        del agent, srv
        held = hold_recorded(K_, T_, {p: log[p] for p in SERVE_KERNEL_PATHS},
                             5, "slice_serve")
    finally:
        time.time = clock
        for srv in servers:
            srv.stop()
        torch.cuda.empty_cache()
    emit({"phase": "slice_serve", "card": smi, "chunks": N_SERVE, **rep,
          "allowed_differences": counts, "launches_by_path": paths,
          "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_serve", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return held


N_IVF, DIM_IVF = 10_485_760, 128  # benchmarks/bench_sharded.py:23-73
IVF_CLUSTERS, IVF_NPROBE, IVF_ITERS, IVF_TILE = 4096, 128, 6, 2048
IVF_NPROBES = (8, 16, 32, 64, 128)
N_IVF_QUERIES = 64
IVF_MIN_SIZE = 32_768             # the agent's upgrade: half the corpus
N_AGENT_IVF_QUERIES = 64


def probe_plan(what, ivf, qn, nprobe, counts):
    """The clusters ``ivf`` probes for unit queries ``qn`` [B, D] (its own
    selection, ``_probe_clusters``) against a float64 ranking of its
    centroids: equal in order unless the ranking shows a near-tie of
    TIE_TOL at that rank (counted). Returns the probe [B, nprobe]."""
    from optimized_rag_tpu_torch.index.ivf import _probe_clusters
    probe = _probe_clusters(qn, ivf._centroids, nprobe)
    s64 = qn.double() @ ivf._centroids.double().T
    want = torch.sort(s64, dim=1, descending=True, stable=True)[1][:, :nprobe]
    differ = probe != want
    if bool(differ.any()):
        gap = (torch.gather(s64, 1, probe) - torch.gather(s64, 1, want)).abs()
        if float(gap[differ].max()) > TIE_TOL:
            raise AssertionError(f"{what}: probed clusters differ from the "
                                 "float64 ranking beyond a near-tie")
        counts["probe_near_tie"] += int(differ.any(dim=1).sum())
    return probe


def ivf_oracle(ivf, qn, probe, k):
    """The float64 top-k of each query over the rows of its probed
    clusters (``probe`` [B, nprobe]), ties to the lower slot: (scores,
    slots, the float64 scorer of a query's slots)."""
    starts, counts = ivf._starts.long(), ivf._counts.long()
    out_s, out_i, scorers = [], [], []
    for j in range(qn.shape[0]):
        st, ct = starts[probe[j]], counts[probe[j]]
        base = torch.repeat_interleave(st - torch.cumsum(ct, 0) + ct, ct)
        slots = base + torch.arange(int(ct.sum()), device=qn.device)
        slots = torch.sort(slots).values
        score = lambda sl, j=j: ivf._sorted_emb[sl].double() @ qn[j].double()
        s = score(slots)
        top_s, pos = torch.sort(s, descending=True, stable=True)
        out_s.append(top_s[:k])
        out_i.append(slots[pos[:k]])
        scorers.append(score)
    return torch.stack(out_s), torch.stack(out_i), scorers


def hold_ivf(what, ids, vals, o_s, o_slots, scorers, inv_perm, perm, counts):
    """An IVF answer (ids, scores; numpy [B, k]) against the probe-plan
    oracle: ids equal unless the oracle shows a near-tie of TIE_TOL
    (counted), scores within TIE_TOL. Returns the worst score error."""
    dev = o_s.device
    want = perm[o_slots.cpu().numpy()]
    for j in np.flatnonzero((ids != want).any(axis=1)):
        mine = scorers[j](inv_perm[torch.from_numpy(ids[j]).to(dev)])
        if float((mine - o_s[j]).abs().max()) > TIE_TOL:
            raise AssertionError(f"{what} query {j}: ids {ids[j].tolist()} "
                                 f"differ from the oracle's "
                                 f"{want[j].tolist()}")
        counts["near_tie"] += 1
    err = float(np.abs(vals - o_s.cpu().numpy()).max())
    if not err <= TIE_TOL:
        raise AssertionError(f"{what}: scores off by {err:.3g}")
    return err


def check_layout(what, ivf, n):
    """counts sum to the rows, starts are their exclusive cumsum, and the
    sort permutation is a permutation."""
    c, st = ivf._counts.long(), ivf._starts.long()
    excl = torch.cumsum(c, 0) - c
    perm = torch.from_numpy(ivf._perm).to(c.device)
    if int(c.sum()) != n or not torch.equal(st, excl) or not bool(
            (torch.bincount(perm, minlength=n) == 1).all()):
        raise AssertionError(f"{what}: counts, starts or the permutation "
                             "are not a layout of the rows")


def recall_at(ids, exact):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids.tolist(), exact.tolist())]))


def phase_slice_ivf(K_, T_, dev, queries, data, smi):
    """IVF on the card. (a) The reference's IVF benchmark shape
    (benchmarks/bench_sharded.py:23-73): 10,485,760 x 128 bf16 rows around
    4,096 seeded centres, ``IVFIndex(4096, nprobe=128, kmeans_iters=6,
    tile=2048)`` built unbalanced (k-means, assignment and sort timed
    apart), 64 perturbed corpus rows as queries, nprobe in {8, ..., 128}:
    each probe held against a float64 ranking of the centroids, each
    answer against the float64 top-10 of its probe plan, the layout
    checked; recall@10 against the exact top-10, qps per nprobe and the
    port's exact search of the same batch printed; the rows and queries
    are returned for slice_sharded. (b) The agent's
    upgrade past ``ivf_min_size`` at D=384: a card agent over slice_serve's
    65,536-chunk snapshot (``data``) with ``ivf_min_size`` 32,768 builds
    the balanced default IVF, ingests a fresh file, answers 64
    ``dense_only`` queries held against the probe plan and the exact tail,
    then 8 chat turns that a CPU agent (the same snapshot, the card's IVF
    through ``state_dict``) replays. Resets the peak memory statistics."""
    import shutil
    from optimized_rag_tpu_torch.index import ivf as ivf_mod
    from optimized_rag_tpu_torch.index.ivf import IVFIndex, _round_up
    from optimized_rag_tpu_torch.ops.similarity import normalize
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep, counts = {}, {"near_tie": 0, "probe_near_tie": 0}

    # (a) The reference's IVF benchmark shape.
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    centers = torch.randn(IVF_CLUSTERS, DIM_IVF, generator=gen,
                          device=dev) * 2.0
    rows = torch.empty(N_IVF, DIM_IVF, dtype=torch.bfloat16, device=dev)
    for lo in range(0, N_IVF, 1 << 20):
        hi = min(N_IVF, lo + (1 << 20))
        rows[lo:hi] = clustered_rows(hi - lo, gen, centers)
    del centers
    pick = torch.randint(0, N_IVF, (N_IVF_QUERIES,), generator=gen,
                         device=dev)
    q = unit(rows[pick].float() + 0.05 * torch.randn(
        N_IVF_QUERIES, DIM_IVF, generator=gen, device=dev))
    qn = normalize(q)                       # as IVFIndex.search has it
    _, exact = oracle_topk(q, rows, N_IVF, K)
    exact = exact.cpu().numpy()
    timed = Counter()

    def timing(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timed[name] += time.perf_counter() - t1
            return out
        return call
    ivf = IVFIndex(num_clusters=IVF_CLUSTERS, nprobe=IVF_NPROBE,
                   kmeans_iters=IVF_ITERS, tile=IVF_TILE, device=dev)
    saved = ivf_mod.kmeans_fit, ivf_mod.kmeans_assign
    ivf_mod.kmeans_fit = timing("kmeans_s", saved[0])
    ivf_mod.kmeans_assign = timing("assign_s", saved[1])
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ivf.build(rows, storage_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
    finally:
        ivf_mod.kmeans_fit, ivf_mod.kmeans_assign = saved
    rep["build"] = {"seconds": build_s, **timed,
                    "sort_and_rest_s": build_s - sum(timed.values()),
                    "clusters": ivf.num_clusters_built,
                    "window": ivf._window,
                    "largest_cluster": int(ivf._counts.max())}
    check_layout("slice_ivf (a)", ivf, N_IVF)
    perm = ivf._perm
    inv_perm = torch.empty(N_IVF, dtype=torch.long, device=dev)
    inv_perm[torch.from_numpy(perm).to(dev)] = torch.arange(N_IVF,
                                                           device=dev)
    sweep = {}
    for nprobe in IVF_NPROBES:
        what = f"slice_ivf (a) nprobe={nprobe}"
        s, ids = ivf.search(q, K, nprobe=nprobe)
        probe = probe_plan(what, ivf, qn, nprobe, counts)
        o_s, o_slots, scorers = ivf_oracle(ivf, qn, probe, K)
        err = hold_ivf(what, ids, s, o_s, o_slots, scorers, inv_perm, perm,
                       counts)
        del o_s, o_slots, scorers, probe
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            ivf.search(q, K, nprobe=nprobe)
            times.append(time.perf_counter() - t1)
        ms = statistics.median(times) * 1e3
        sweep[nprobe] = {"ms": ms, "qps": N_IVF_QUERIES / ms * 1e3,
                         "recall_at_10": recall_at(ids, exact),
                         "rows_read": nprobe * ivf._window * N_IVF_QUERIES,
                         "oracle_max_err": err}
    rep["nprobe_sweep"] = sweep
    exact_ms = median_ms(lambda: T_.dispatch_topk(
        q, rows, K, N_IVF, tile=BENCH_TILE), 5)
    rep["exact_search"] = {"route": "dispatch_topk, bf16 rows, tile "
                           f"{BENCH_TILE}", "ms": exact_ms,
                           "qps": N_IVF_QUERIES / exact_ms * 1e3}
    rep["peak_device_gbytes_a"] = torch.cuda.max_memory_allocated() / 1e9
    del ivf, inv_perm, qn           # slice_sharded takes the rows and q
    torch.cuda.empty_cache()

    # (b) The agent's upgrade past ivf_min_size.
    work = os.path.dirname(data)
    forks = [os.path.join(work, f"ivf_{name}") for name in ("card", "cpu")]
    for fork in forks:
        shutil.copytree(data, fork)
    fresh = os.path.join(work, "fresh_notes.txt")
    with open(fresh, "w", encoding="utf-8") as f:
        f.write(FRESH_TEXT)
    clock = time.time
    now = clock()
    time.time = lambda: now
    try:
        agent = serving_agent(forks[0], dev)
        agent.warmup()
        agent.settings.ivf.ivf_min_size = IVF_MIN_SIZE
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kind = agent.maybe_upgrade_index()
        torch.cuda.synchronize()
        ann = agent.retriever.ann
        s_ivf = agent.settings.ivf
        cap = int(np.ceil(N_SERVE / s_ivf.num_clusters * 1.15))
        rep["agent_build"] = {
            "seconds": time.perf_counter() - t1, "kind": kind,
            "clusters": ann.num_clusters_built, "nprobe": ann.nprobe,
            "window": ann._window, "cap": cap,
            "largest_cluster": int(ann._counts.max())}
        if (kind != "ivf" or type(ann) is not IVFIndex
                or not s_ivf.balanced_build
                or ann.num_clusters_built != s_ivf.num_clusters
                or ann.nprobe != s_ivf.nprobe
                or agent.retriever.ann_size != N_SERVE
                or int(ann._counts.max()) > cap
                or ann._window != _round_up(cap, 128)):
            raise AssertionError(f"slice_ivf (b) upgrade: "
                                 f"{rep['agent_build']}")
        check_layout("slice_ivf (b)", ann, N_SERVE)
        up = agent.ingestor.upload_file(fresh)
        if not up["ok"] or agent.dense.size <= N_SERVE or \
                agent.retriever.ann is not ann:
            raise AssertionError(f"slice_ivf (b) fresh ingest: {up}")
        texts = [FRESH_TEXT] + queries[0][:N_AGENT_IVF_QUERIES - 1]
        answers = [agent.retriever.dense_only(t, K) for t in texts]
        if not any(d.doc_id >= N_SERVE for d in answers[0]):
            raise AssertionError("slice_ivf (b): the fresh tail was not "
                                 "found")
        qvec = torch.from_numpy(agent.embedder.encode(texts)).to(dev)
        qn = normalize(qvec.float())
        probe = probe_plan("slice_ivf (b)", ann, qn, ann.nprobe, counts)
        o_s, o_slots, _ = ivf_oracle(ann, qn, probe, K)
        tail = agent.dense.embeddings()[N_SERVE:agent.dense.size].double()
        t_s = qvec.double() @ tail.T
        t_s, t_i = torch.sort(t_s, dim=1, descending=True, stable=True)
        kt = min(K, tail.shape[0])
        # The union as _ann_candidates forms it: the ANN's k, then the
        # tail's, one stable sort.
        cand_s = torch.cat([o_s, t_s[:, :kt]], dim=1)
        cand_i = torch.cat([torch.from_numpy(ann._perm).to(dev)[o_slots],
                            t_i[:, :kt] + N_SERVE], dim=1)
        w_s, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
        w_s, w_i = w_s[:, :K].cpu().numpy(), torch.gather(
            cand_i, 1, pos[:, :K]).cpu().numpy()
        rows64 = agent.dense.embeddings()[:agent.dense.size].double()
        err = 0.0
        for j, docs in enumerate(answers):
            ids = np.array([d.doc_id for d in docs])
            vals = np.array([d.score for d in docs], np.float64)
            if (ids != w_i[j]).any():
                mine = (rows64[torch.from_numpy(ids).to(dev)]
                        @ qn[j].double()).cpu().numpy()
                if np.abs(mine - w_s[j]).max() > TIE_TOL:
                    raise AssertionError(
                        f"slice_ivf (b) dense_only {j}: ids {ids.tolist()} "
                        f"differ from the oracle's {w_i[j].tolist()}")
                counts["near_tie"] += 1
            err = max(err, float(np.abs(vals - w_s[j]).max()))
        if not err <= TIE_TOL:
            raise AssertionError(f"slice_ivf (b): scores off by {err:.3g}")
        _, ann_ids = ann.search(qvec.cpu().numpy(), K)
        exact_b = torch.sort(qvec.double() @ rows64[:N_SERVE].T, dim=1,
                             descending=True, stable=True)[1][:, :K]
        rep["agent_dense_only"] = {
            "queries": len(texts), "oracle_max_err": err,
            "recall_at_10": recall_at(ann_ids, exact_b.cpu().numpy())}
        del rows64, tail, o_s, o_slots, probe
        chat_texts = [q for q, _ in QA_SESSION]
        card = [turn(agent, text) for text in chat_texts]
        rep["agent_chat"] = route_stats([t["ms"] for t in card])
        state = ann.state_dict()
        del agent, ann
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cpu_agent = serving_agent(forks[1], "cpu")
        cpu_agent.warmup()
        cpu_agent.settings.ivf.ivf_min_size = IVF_MIN_SIZE
        cpu_agent.retriever.ann = IVFIndex.from_state_dict(state,
                                                           device="cpu")
        cpu_agent.retriever.ann_size = N_SERVE
        up = cpu_agent.ingestor.upload_file(fresh)
        if not up["ok"] or type(cpu_agent.retriever.ann) is not IVFIndex:
            raise AssertionError(f"slice_ivf (b) CPU fresh ingest: {up}")
        replay("ivf_agent", card, cpu_agent, chat_texts, counts,
               phase="slice_ivf")
        rep["cpu_replay_seconds"] = time.perf_counter() - t1
        del cpu_agent
    finally:
        time.time = clock
        torch.cuda.empty_cache()
    emit({"phase": "slice_ivf", "card": smi, "rows": N_IVF, "dim": DIM_IVF,
          **rep, "allowed_differences": counts,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    return rows, q


# ---------------------------------------------------------- slice_sharded

N_SHARDS = 4                      # benchmarks/bench_sharded.py's mesh
SHARD_TILE = 1024
SHARD_BATCHES = (64, 1024)
SHARD_IMPLS = ("kernel", "auto")
# "auto" (exact_topk) scores a whole shard per query in float32 and sorts it:
# [1024, 2,621,440] would need about 55 GB, so B=1024 goes in batches of 64.
AUTO_SUB_BATCH = 64
SHARD_MIN_SIZE = 32_768           # the agent's upgrade: half the corpus
N_SHARD_AGENT_QUERIES = 64


def shard_devices(dev):
    """N_SHARDS devices: the machine's cards in turn, so one card holds all
    four shards and several cards hold one or more each."""
    n = torch.cuda.device_count()
    return [dev if n == 1 else torch.device("cuda", i % n)
            for i in range(N_SHARDS)]


def count_syncs(fn):
    """``fn()`` under CUDA's sync debug mode: (its result, the number of
    operations in it that made the host wait for the device)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def host_ms(fn, reps):
    """Median host-clock ms of ``fn`` (which ends in a host copy; the
    callers have run it once already)."""
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t1)
    return statistics.median(times) * 1e3


def sharded_rows(idx):
    """(first external id of each shard and the total, a scorer of
    external ids) of a ShardedDenseIndex laid out by ``bulk_build``: shard
    s holds ids [starts[s], starts[s+1]) in order."""
    starts = np.concatenate([[0], np.cumsum(idx._sizes)])

    def rows(ids):
        ids = np.asarray(ids, np.int64)
        s = np.searchsorted(starts, ids, side="right") - 1
        return torch.stack([idx._emb[int(a)][int(b)] for a, b in
                            zip(s, ids - starts[s])])
    return starts, rows


def sharded_oracle(idx, q, k):
    """The chunked exact float32 top-k over the rows as ``idx`` stores
    them, ties to the lower id: [B, k] scores, ids."""
    starts, _ = sharded_rows(idx)
    qf = q.float()

    def score(lo, hi):
        s = int(np.searchsorted(starts, lo, side="right") - 1)
        if hi > starts[s + 1]:
            raise AssertionError("an oracle chunk straddles two shards")
        return qf @ idx._emb[s][lo - starts[s]:hi - starts[s]].to(
            qf.device).float().T
    return running_topk(score, idx.size, k, q.shape[0], q.device,
                        chunk=math.gcd(262_144, idx.shard_capacity))


def hold_exact(what, ids, vals, o_s, o_i, score_ids, counts):
    """Answers (numpy [B, k]) against an exact oracle's: ids equal unless
    the oracle shows a near-tie of TIE_TOL (the returned ids score the
    oracle's values within TIE_TOL; counted), scores within TIE_TOL.
    Returns the worst score error."""
    want, o_s = np.asarray(o_i), np.asarray(o_s, np.float64)
    for j in np.flatnonzero((ids != want).any(axis=1)):
        mine = score_ids(j, ids[j])
        if np.abs(mine - o_s[j]).max() > TIE_TOL:
            raise AssertionError(f"{what} query {j}: ids {ids[j].tolist()} "
                                 f"differ from the oracle's "
                                 f"{want[j].tolist()}")
        counts["near_tie"] += 1
    err = float(np.abs(vals - o_s).max())
    if not err <= TIE_TOL:
        raise AssertionError(f"{what}: scores off by {err:.3g}")
    return err


def sharded_ivf_oracle(what, sivf, qn, nprobe, k, counts):
    """The exact top-k over the rows each shard's probe plan covers: every
    shard's probed clusters (its own ``_probe_clusters`` over its owned
    clusters) held against a float64 ranking of those centroids (near-ties
    of TIE_TOL counted); then, shard by shard, the chunked float32 top-k of
    the rows in the query's probed clusters, and the stable merge of the
    shards' winners. Returns (scores [B, k], external ids [B, k]) as
    numpy."""
    from optimized_rag_tpu_torch.index.ivf import _probe_clusters
    b, dev = qn.shape[0], qn.device
    cand_s, cand_r = [], []
    for s, cent, emb, starts, cnts, owned in sivf._shards:
        probe = _probe_clusters(qn, cent, nprobe, owned)
        s64 = torch.where(owned[None, :], qn.double() @ cent.double().T,
                          float("-inf"))
        want = torch.sort(s64, dim=1, descending=True, stable=True)[1]
        m = min(nprobe, int(owned.sum()))
        differ = probe[:, :m] != want[:, :m]
        if bool(differ.any()):
            gap = (torch.gather(s64, 1, probe[:, :m])
                   - torch.gather(s64, 1, want[:, :m])).abs()
            if float(gap[differ].max()) > TIE_TOL:
                raise AssertionError(f"{what} shard {s}: probed clusters "
                                     "differ from the float64 ranking")
            counts["probe_near_tie"] += int(differ.any(dim=1).sum())
        member = torch.zeros(b, cent.shape[0], dtype=torch.bool, device=dev)
        member.scatter_(1, probe.to(dev), True)
        live = int(cnts.sum())
        cluster = torch.repeat_interleave(
            torch.arange(cent.shape[0], device=dev), cnts.long().to(dev))
        block = emb.to(dev)

        def score(lo, hi):
            sc = qn @ block[lo:hi].float().T
            return torch.where(member[:, cluster[lo:hi]], sc, float("-inf"))
        top_s, top_i = running_topk(score, live, k, b, dev)
        cand_s.append(top_s)
        cand_r.append(torch.where(top_i >= 0, top_i + s * sivf._npad, -1))
    top_s, pos = torch.sort(torch.cat(cand_s, dim=1), dim=1, descending=True,
                            stable=True)
    rows = torch.gather(torch.cat(cand_r, dim=1), 1, pos[:, :k]).cpu().numpy()
    return top_s[:, :k].cpu().numpy(), sivf._row_to_ext[rows]


def phase_slice_sharded(K_, T_, dev, handed, queries, data, smi):
    """Sharded retrieval over a device mesh. The mesh: N_SHARDS=4 data
    shards, on distinct cards where the machine has them, else all on
    this card (one stream: the sharded code path, not NVLink or NCCL).
    (a) ``ShardedDenseIndex`` (bf16, tile 1024) loaded by ``bulk_build``
    from slice_ivf's 10,485,760 x 128 rows on the card: 2,621,440 rows
    (2,560 tiles) a shard; B=64 (slice_ivf's queries) and B=1024 at k=10,
    ``impl="kernel"`` (topk_verified with K6 at tile_k 2 on every shard)
    and ``"auto"`` (exact_topk; B=1024 in batches of 64), every answer
    against the chunked exact float32 search of the stored rows with the
    route's queries (bf16-rounded for the kernel route; near-ties of 1e-5
    counted); K6's launches per path, host syncs per search, ms and qps. (b) ``ShardedIVFIndex`` (4,096 clusters, 6 iterations, tile 2048)
    built from the same rows; nprobe 8-128 on the B=64 queries, each answer
    against the float64 top-10 of the shards' probe plans, recall@10
    against (a)'s oracle. (c) The agent's sharded upgrade over
    slice_serve's 65,536-chunk snapshot (``data``): data_parallel 4,
    ``shard_min_size`` 32,768, ``mesh_or_none`` handed the phase's
    devices; 64 ``dense_only`` queries against a float64 oracle and 8 chat
    turns that a CPU agent (its mesh on 4 logical CPU devices) replays.
    ``handed`` is [rows, queries] from slice_ivf: the phase takes the
    only references, and (b)'s build frees the rows once it has normalised
    them. Returns the K6 records of (a)'s kernel paths. Resets the peak
    memory statistics."""
    import functools
    import shutil
    from optimized_rag_tpu_torch.index import policy
    from optimized_rag_tpu_torch.ops.similarity import normalize
    from optimized_rag_tpu_torch.parallel.mesh import make_mesh
    from optimized_rag_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
    from optimized_rag_tpu_torch.parallel.sharded_topk import (
        ShardedDenseIndex)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep, counts = {}, {"near_tie": 0, "probe_near_tie": 0}
    rows, q64 = handed
    handed[1] = None
    devices = shard_devices(dev)
    mesh = make_mesh(data=N_SHARDS, devices=devices)
    rep["mesh"] = {"shape": mesh.shape, "devices": [str(d) for d in devices],
                   "shards_on_one_card": len(set(devices)) == 1}
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    pick = torch.randint(0, N_IVF, (SHARD_BATCHES[-1],), generator=gen,
                         device=dev)
    batches = {64: q64, SHARD_BATCHES[-1]: unit(rows[pick].float() + 0.05
                                                * torch.randn(
        SHARD_BATCHES[-1], DIM_IVF, generator=gen, device=dev))}

    # (a) ShardedDenseIndex.
    idx = ShardedDenseIndex(DIM_IVF, mesh, capacity_block=N_IVF,
                            dtype=torch.bfloat16, tile=SHARD_TILE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    idx.bulk_build(rows)
    torch.cuda.synchronize()
    rep["dense_build_seconds"] = time.perf_counter() - t1
    if (idx.shard_capacity != N_IVF // N_SHARDS
            or (idx._sizes != N_IVF // N_SHARDS).any()):
        raise AssertionError(f"slice_sharded: shards {idx._sizes} of "
                             f"capacity {idx.shard_capacity}")
    _, stored = sharded_rows(idx)
    qns = {b: normalize(q) for b, q in batches.items()}  # as search has them
    # The kernel route scores bf16(q) x bf16 rows (the kernels' function,
    # ops/topk._exact_rowwise_scores); exact_topk scores f32 q.
    scored = {(impl, b): qn.to(torch.bfloat16).float() if impl == "kernel"
              else qn for impl in SHARD_IMPLS for b, qn in qns.items()}
    oracle = {key: sharded_oracle(idx, qs, K) for key, qs in scored.items()}
    paths, log, search = {}, {}, {}
    for impl in SHARD_IMPLS:
        for b, q in batches.items():
            name = f"{impl}_b{b}"
            sub = AUTO_SUB_BATCH if impl == "auto" else b

            def run(q=q, b=b, sub=sub, impl=impl):
                got = [idx.search(q[i:i + sub], K, impl=impl)
                       for i in range(0, b, sub)]
                return (np.concatenate([g[0] for g in got]),
                        np.concatenate([g[1] for g in got]))
            slow = impl == "auto" and b > AUTO_SUB_BATCH   # seconds a call
            t1 = time.perf_counter()
            if impl == "kernel":
                with recording(T_, K_, log.setdefault(f"sharded_{name}", [])):
                    vals, ids = counted(K_, paths, f"sharded_{name}", run)
                if paths[f"sharded_{name}"]["tile_topk"] != N_SHARDS:
                    raise AssertionError(f"slice_sharded {name}: K6 launched "
                                         f"{paths[f'sharded_{name}']}")
            else:
                vals, ids = run()
            first_ms = (time.perf_counter() - t1) * 1e3
            o_s, o_i = oracle[impl, b]
            err = hold_exact(
                f"slice_sharded {name}", ids, vals, o_s.cpu().numpy(),
                o_i.cpu().numpy(), lambda j, got, qs=scored[impl, b]: (
                    stored(got).double() @ qs[j].double()).cpu().numpy(),
                counts)
            _, syncs = count_syncs(lambda: idx.search(q[:sub], K, impl=impl))
            ms = first_ms if slow else host_ms(run, 5 if impl == "kernel"
                                               else 3)
            search[name] = {"ms": ms, "qps": b / ms * 1e3,
                            "sub_batch": sub, "oracle_max_err": err,
                            "host_syncs_per_search": syncs}
    rep["dense"] = search
    for p, calls in log.items():
        seen_calls = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
        if seen_calls != paths[p]:
            raise AssertionError(f"slice_sharded {p}: recorded {seen_calls}, "
                                 f"counted {paths[p]}")
    held = hold_recorded(K_, T_, log, 5, "slice_sharded")
    exact64 = oracle["auto", 64][1].cpu().numpy()
    del idx, oracle, stored, scored
    torch.cuda.empty_cache()
    rep["peak_device_gbytes_a"] = torch.cuda.max_memory_allocated() / 1e9
    rep["device_gbytes_after_a"] = torch.cuda.memory_allocated() / 1e9

    # (b) ShardedIVFIndex.
    sivf = ShardedIVFIndex(mesh, num_clusters=IVF_CLUSTERS,
                           nprobe=IVF_NPROBE, kmeans_iters=IVF_ITERS,
                           tile=IVF_TILE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    del rows, batches, pick
    sivf.build(handed.pop(0), storage_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    rep["peak_device_gbytes_ivf_build"] = (torch.cuda.max_memory_allocated()
                                           / 1e9)
    owned = [int(sh[5].sum()) for sh in sivf._shards]
    rep["ivf_build"] = {"seconds": time.perf_counter() - t1,
                        "clusters": sivf.num_clusters_built,
                        "clusters_per_shard": owned,
                        "rows_per_shard": [int(sh[4].sum())
                                           for sh in sivf._shards],
                        "window": sivf._window, "npad": sivf._npad}
    if sum(owned) != IVF_CLUSTERS or sum(
            rep["ivf_build"]["rows_per_shard"]) != N_IVF:
        raise AssertionError(f"slice_sharded (b): {rep['ivf_build']}")
    valid = sivf._row_to_ext >= 0
    inv = np.empty(N_IVF, np.int64)
    inv[sivf._row_to_ext[valid]] = np.flatnonzero(valid)
    shards = {sh[0]: sh[2] for sh in sivf._shards}

    def ivf_scores(j, got):
        r = inv[got]
        return np.array([float(shards[int(x // sivf._npad)][
            int(x % sivf._npad)].double() @ qn[j].double()) for x in r])
    qn = qns[64]
    sweep = {}
    for nprobe in IVF_NPROBES:
        what = f"slice_sharded (b) nprobe={nprobe}"
        vals, ids = sivf.search(q64, K, nprobe=nprobe)
        o_s, o_i = sharded_ivf_oracle(what, sivf, qn, nprobe, K, counts)
        err = hold_exact(what, ids, vals, o_s, o_i, ivf_scores, counts)
        ms = host_ms(lambda: sivf.search(q64, K, nprobe=nprobe), 3)
        sweep[nprobe] = {"ms": ms, "qps": 64 / ms * 1e3,
                         "recall_at_10": recall_at(ids, exact64),
                         "rows_read": N_SHARDS * nprobe * sivf._window * 64,
                         "oracle_max_err": err}
    _, syncs = count_syncs(lambda: sivf.search(q64, K))
    rep["ivf_nprobe_sweep"] = sweep
    rep["ivf_host_syncs_per_search"] = syncs
    rep["peak_device_gbytes_ab"] = torch.cuda.max_memory_allocated() / 1e9
    del sivf, shards, inv
    torch.cuda.empty_cache()

    # (c) The agent's sharded upgrade.
    work = os.path.dirname(data)
    forks = [os.path.join(work, f"sharded_{n}") for n in ("card", "cpu")]
    for fork in forks:
        shutil.copytree(data, fork)
    clock, now = time.time, time.time()
    time.time = lambda: now
    handed = policy.mesh_or_none
    try:
        def upgrade(agent, devs):
            s = agent.settings
            s.mesh.data_parallel = N_SHARDS
            s.ivf.shard_min_size = SHARD_MIN_SIZE
            policy.mesh_or_none = functools.partial(handed, devices=devs)
            try:
                return agent.maybe_upgrade_index()
            finally:
                policy.mesh_or_none = handed
        agent = serving_agent(forks[0], dev)
        agent.warmup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kind = upgrade(agent, devices)
        torch.cuda.synchronize()
        ann = agent.retriever.ann
        rep["agent_upgrade"] = {
            "seconds": time.perf_counter() - t1, "kind": kind,
            "type": type(ann).__name__, "ann_size": agent.retriever.ann_size,
            "shard_sizes": ann._sizes.tolist()}
        if (kind != "sharded_dense" or type(ann).__name__ !=
                "ShardedDenseIndex" or agent.retriever.ann_size != N_SERVE
                or ann.ndev != N_SHARDS
                or {e.device.type for e in ann._emb} != {dev.type}):
            raise AssertionError(f"slice_sharded (c): {rep['agent_upgrade']}")
        texts = queries[0][:N_SHARD_AGENT_QUERIES]
        answers = [[{"doc_id": d.doc_id, "score": d.score} for d in
                    agent.retriever.dense_only(t, K)] for t in texts]
        rows64 = agent.dense.embeddings()[:agent.dense.size].double()
        rep["agent_dense_only"] = {
            "queries": len(texts), "oracle_max_err": hold_served(
                "slice_sharded (c) dense_only", answers,
                list(agent.embedder.encode(texts)), rows64, counts)}
        del rows64
        chat_texts = [q for q, _ in QA_SESSION]
        card = [turn(agent, text) for text in chat_texts]
        rep["agent_chat"] = route_stats([t["ms"] for t in card])
        del agent, ann
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cpu_agent = serving_agent(forks[1], "cpu")
        cpu_agent.warmup()
        if upgrade(cpu_agent, None) != "sharded_dense":
            raise AssertionError("slice_sharded (c): the CPU agent did not "
                                 "shard")
        replay("sharded_agent", card, cpu_agent, chat_texts, counts,
               phase="slice_sharded")
        rep["cpu_replay_seconds"] = time.perf_counter() - t1
        del cpu_agent
    finally:
        time.time = clock
        policy.mesh_or_none = handed
        for fork in forks:
            shutil.rmtree(fork, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "slice_sharded", "card": smi, "rows": N_IVF,
          "dim": DIM_IVF, **rep, "allowed_differences": counts,
          "launches_by_path": paths,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_sharded", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return held


# --------------------------------------------------------- slice_local_lm

LM_CKPT = os.path.join(HERE, "checkpoints", "grounded_r5")
DECODER_CKPT = os.path.join(HERE, "checkpoints", "pretrained")
N_LM_PROMPTS, N_LM_REPLAY = 8, 2
LM_DOCS = 5                       # retrieved chunks a prompt renders
DECODER_PROMPT, DECODER_NEW, N_DECODER_REPLAY = 768, 128, 2
N_LM_CHAT_TURNS = 2
# A near-tie between the card's and the CPU's bfloat16 sums: the margin of a
# step's top two scores (log-probs or logits) within this, as
# tests/test_torch_grounded.py and tests/test_torch_decoder.py hold the JAX
# package against the port.
GEN_TIE = 1.0


def lm_prompts(chunks, dev, max_bytes):
    """N_LM_PROMPTS prompts rendered by ``render_prompt`` from the qa
    session's questions and the LM_DOCS chunks the pretrained BiEncoder
    ranks first for each (cosine, ties to the lower chunk)."""
    from optimized_rag_tpu_torch.models.convert import load_biencoder
    from optimized_rag_tpu_torch.models.grounded import render_prompt
    svc = load_biencoder(DECODER_CKPT, device=dev)
    questions = [q for q, _ in QA_SESSION][:N_LM_PROMPTS]
    sims = torch.from_numpy(svc.encode(questions)) @ torch.from_numpy(
        svc.encode(chunks)).T
    top = torch.sort(sims, dim=1, descending=True, stable=True)[1][:, :LM_DOCS]
    return [render_prompt([chunks[i] for i in top[j].tolist()], q,
                          max_bytes=max_bytes)
            for j, q in enumerate(questions)]


def generated(gen, prompts):
    """Greedy tokens of each prompt (through its EOS, no PAD) and the
    scores every decode step picked from ([B, V] float32 on the host, one a
    step: the grounded mixture's log-probs, the decoder's logits)."""
    from optimized_rag_tpu_torch.models import decoder as pd
    from optimized_rag_tpu_torch.models import grounded as pg
    mod = pg if isinstance(gen, pg.GroundedGenerator) else pd
    loop, scores = mod.decode_loop, []

    def recording_loop(first, step, pick, max_new, **kw):
        def keep(s):
            scores.append(s.float().cpu())
            return pick(s)
        return loop(first, step, keep, max_new, **kw)
    ids, pad = pd.left_pad(prompts, gen.max_prompt_len)
    args = ((0.0, 0, 1.0, 0) if mod is pd else (0.0, 0))
    mod.decode_loop = recording_loop
    try:
        toks = gen._generate(torch.from_numpy(ids).to(gen.device),
                             torch.from_numpy(pad).to(gen.device), *args,
                             gen.max_new_tokens)
    finally:
        mod.decode_loop = loop
    rows = [[t for t in row if t != pd.PAD] for row in toks.T.tolist()]
    return rows, scores, pd.texts_of(toks)


def hold_generated(what, card, cpu, counts):
    """Greedy tokens of the card against the CPU's (each ``generated``'s
    rows and step scores): equal, or equal up to a step where the CPU run
    shows a near-tie: its top two are the CPU's token and the card's,
    within GEN_TIE (counted, with both runs' margins; the rest of that row
    is not compared). Records the largest difference of the two runs'
    scores over each step's top 5 up to any divergence."""
    (c_rows, c_sc), (p_rows, p_sc) = card, cpu
    log = counts.setdefault(what, {"equal": 0, "near_tie": [],
                                   "step_score_max_diff": 0.0})
    for j, (a, b) in enumerate(zip(c_rows, p_rows)):
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None)
        for s in range(len(a) if t is None else t + 1):
            top = torch.topk(c_sc[s][j], 5).indices
            log["step_score_max_diff"] = max(log["step_score_max_diff"], float(
                (c_sc[s][j][top] - p_sc[s][j][top]).abs().max()))
        if t is None and len(a) == len(b):
            log["equal"] += 1
            continue
        cs, ps = c_sc[t][j], p_sc[t][j]
        pair = {a[t], b[t]}
        margins = (float(cs[a[t]] - cs[b[t]]), float(ps[b[t]] - ps[a[t]]))
        if (set(torch.topk(ps, 2).indices.tolist()) != pair
                or margins[1] > GEN_TIE):
            raise AssertionError(
                f"slice_local_lm {what} prompt {j}: at step {t} the card "
                f"picks {a[t]}, the CPU {b[t]}; top two on the card "
                f"{torch.topk(cs, 2)}, on the CPU {torch.topk(ps, 2)}")
        log["near_tie"].append({"prompt": j, "step": t,
                                "margins": margins})


def timed_generation(mod, gen, prompts, **kw):
    """``gen.generate_batch(prompts)`` timed on the host clock, split at
    the end of the prefill (where ``mod.decode_loop`` is entered, after a
    synchronize): texts and {wall_ms, prefill_ms, decode_ms, steps,
    decode_ms_per_step, tokens (non-PAD, EOS included), tokens_per_s
    (tokens over the whole call), decode_tokens_per_s}."""
    loop, mark = mod.decode_loop, {}

    def timed_loop(first, step, pick, max_new, **kw2):
        torch.cuda.synchronize()
        mark["prefill"] = time.perf_counter()
        n = [1]

        def counting(toks, t):
            n[0] += 1
            return step(toks, t)
        out = loop(first, counting, pick, max_new, **kw2)
        mark["steps"], mark["tokens"] = n[0], int((out != 0).sum())
        return out
    mod.decode_loop = timed_loop
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts = gen.generate_batch(prompts, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        mod.decode_loop = loop
    decode = t1 - mark["prefill"]
    return texts, {"B": len(prompts), "wall_ms": (t1 - t0) * 1e3,
                   "prefill_ms": (mark["prefill"] - t0) * 1e3,
                   "decode_ms": decode * 1e3, "steps": mark["steps"],
                   "decode_ms_per_step": decode * 1e3 / mark["steps"],
                   "tokens": mark["tokens"],
                   "tokens_per_s": mark["tokens"] / (t1 - t0),
                   "decode_tokens_per_s": mark["tokens"] / decode}


class GenTieLog(TieLog):
    """TieLog, and a generation near-tie: a decode step of the grounded
    generator whose top two log-probs lie within GEN_TIE."""

    def __enter__(self):
        from optimized_rag_tpu_torch.models import grounded as pg
        self._pg, self._loop = pg, pg.decode_loop

        def loop(first, step, pick, max_new, **kw):
            def watch(scores):
                top = torch.topk(scores.float(), 2, dim=-1).values
                if float((top[:, 0] - top[:, 1]).min()) <= GEN_TIE:
                    self.kinds["generate"] += 1
                return pick(scores)
            return self._loop(first, step, watch, max_new, **kw)
        pg.decode_loop = loop
        return super().__enter__()

    def __exit__(self, *exc):
        self._pg.decode_loop = self._loop
        return super().__exit__(*exc)


def phase_slice_local_lm(dev, chunks, work, smi):
    """The local generators behind ``--local-lm`` on the card. (a)
    ``GroundedGenerator`` on ``checkpoints/grounded_r5`` (6 layers, 384
    wide, prompt 1,792, up to 384 new tokens, greedy): 8 prompts rendered
    from qa session questions and their retrieved chunks; prefill ms,
    decode ms a step and tokens/s at B=1 and B=8, the device's idle share
    over the B=8 call and over its decode (the call less a prefill-only
    call); 2 of the prompts replayed on the CPU, their tokens equal to the
    card's up to a counted near-tie (the CPU run's top two scores at the
    first difference are the two tokens, within GEN_TIE). (b) ``Generator`` on
    ``checkpoints/pretrained/decoder`` (prompt 768, 128 new): the same
    timings, 2 prompts replayed on the CPU. (c) ``cli.main(["chat",
    "--local-lm", "--device", "cuda"])`` in process with
    ``ORAG_LOCAL_LM_CKPT`` naming the grounded checkpoint, over a data
    directory of the qa_docs (uploaded by a card agent under ``work``),
    two questions on stdin; then two RAGAgent turns with the
    GroundedProvider (``cli.build_agent(..., local_lm=True)``) on the card
    over a copy, replayed by a CPU agent over another: equal, near-ties
    excused and counted."""
    import builtins
    import io
    import shutil
    from optimized_rag_tpu_torch import cli
    from optimized_rag_tpu_torch.config import Settings
    from optimized_rag_tpu_torch.models import decoder as pd
    from optimized_rag_tpu_torch.models import grounded as pg
    from optimized_rag_tpu_torch.models.pretrain import load_pretrained
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rep, counts = {}, {}

    # (a) GroundedGenerator.
    cfg, state = load_pretrained(LM_CKPT, "grounded")
    prompt_len = min(cfg.prompt_len, cfg.max_seq_len - cfg.target_len)
    mk = lambda device: pg.GroundedGenerator(  # noqa: E731
        cfg, params=state, max_prompt_len=prompt_len,
        max_new_tokens=cfg.target_len, device=device)
    gen = mk(dev)
    prompts = lm_prompts(chunks, dev, prompt_len - 32)
    gen.generate_batch(prompts[:1], max_new_tokens=4)        # warm-up
    timings = {}
    for b in (1, N_LM_PROMPTS):
        texts, timings[f"b{b}"] = timed_generation(pg, gen, prompts[:b])
    if not any(t.strip() for t in texts):
        raise AssertionError(f"slice_local_lm (a): empty answers {texts}")
    card = generated(gen, prompts[:N_LM_REPLAY])[:2]   # the CPU's batch
    timings["device_b8"] = device_busy(lambda: gen.generate_batch(prompts),
                                       cpu=False)
    pre = device_busy(lambda: gen.generate_batch(prompts, max_new_tokens=1),
                      cpu=False)
    full = timings["device_b8"]
    timings["decode_idle_share"] = 1.0 - (
        full["device_busy_ms"] - pre["device_busy_ms"]) / (
        full["wall_ms"] - pre["wall_ms"])
    rep["grounded"] = {"prompt_len": prompt_len,
                       "max_new_tokens": cfg.target_len,
                       "prompt_bytes": [len(p.encode()) for p in prompts],
                       "answers": [t[:160] for t in texts], **timings}
    del gen
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    cpu_gen = mk("cpu")
    hold_generated("grounded", card, generated(cpu_gen, prompts[
        :N_LM_REPLAY])[:2], counts)
    rep["grounded"]["cpu_replay_seconds"] = time.perf_counter() - t1
    del cpu_gen, card

    # (b) Generator (the plain decoder).
    cfg_d, state_d = load_pretrained(DECODER_CKPT, "decoder")
    mk_d = lambda device: pd.Generator(  # noqa: E731
        cfg_d, params=state_d, max_prompt_len=DECODER_PROMPT,
        max_new_tokens=DECODER_NEW, device=device)
    dec = mk_d(dev)
    dec.generate_batch(prompts[:1], max_new_tokens=4)
    timings = {}
    for b in (1, N_LM_PROMPTS):
        _, timings[f"b{b}"] = timed_generation(pd, dec, prompts[:b])
    card_d = generated(dec, prompts[:N_DECODER_REPLAY])[:2]
    del dec
    hold_generated("decoder", card_d, generated(
        mk_d("cpu"), prompts[:N_DECODER_REPLAY])[:2], counts)
    rep["decoder"] = timings
    del card_d

    # (c) chat --local-lm, then agent turns replayed on the CPU.
    data = os.path.join(work, "local_lm_data")
    agent = serving_agent(data, dev)          # its store on disk
    agent.ingestor.upload_directory(QA_DOCS)
    agent.save_indexes()
    del agent
    forks = [data] + [os.path.join(work, f"local_lm_{n}")
                      for n in ("card", "cpu")]
    for fork in forks[1:]:
        shutil.copytree(data, fork)
    saved_env = {k: os.environ.get(k) for k in ("ORAG_LOCAL_LM_CKPT",
                                                "ORAG_DATA_DIR")}
    clock, now, ask = time.time, time.time(), builtins.input
    time.time = lambda: now
    questions = [q for q, _ in QA_SESSION][:N_LM_CHAT_TURNS]
    try:
        os.environ["ORAG_LOCAL_LM_CKPT"] = LM_CKPT
        os.environ["ORAG_DATA_DIR"] = forks[0]
        feed = iter(questions + ["exit"])
        builtins.input = lambda *a: next(feed)
        out = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["chat", "--local-lm", "--device", dev.type])
        said = out.getvalue()
        rep["cli_chat"] = {"seconds": time.perf_counter() - t1, "rc": rc,
                           "answers": [ln[:200] for ln in said.splitlines()
                                       if ln.startswith("Assistant:")]}
        if rc != 0 or not said.startswith(
                "local LM: loaded grounded checkpoint") or len(
                rep["cli_chat"]["answers"]) != N_LM_CHAT_TURNS:
            raise AssertionError(f"slice_local_lm (c) chat: rc {rc}, "
                                 f"{said[:600]!r}")

        def lm_agent(fork, device):
            settings = Settings.from_env()
            settings.data_dir = fork
            agent = cli.build_agent(settings, local_lm=True, device=device)
            if type(agent.llm) is not pg.GroundedProvider:
                raise AssertionError(f"slice_local_lm (c): {agent.llm}")
            agent.warmup()
            return agent
        agent = lm_agent(forks[1], dev)
        card_turns = [turn(agent, q) for q in questions]
        rep["agent_turns"] = {**route_stats([t["ms"] for t in card_turns]),
                              "answers": [t["answer"][:160]
                                          for t in card_turns]}
        del agent
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cpu_agent = lm_agent(forks[2], "cpu")
        replay("local_lm_agent", card_turns, cpu_agent, questions, counts,
               phase="slice_local_lm", tie_log=GenTieLog)
        rep["cpu_replay_seconds"] = time.perf_counter() - t1
        del cpu_agent
    finally:
        time.time, builtins.input = clock, ask
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for fork in forks:
            shutil.rmtree(fork, ignore_errors=True)
        torch.cuda.empty_cache()
    emit({"phase": "slice_local_lm", "card": smi, **rep,
          "allowed_differences": counts,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------------- training

TRAIN_CKPT = DECODER_CKPT          # checkpoints/pretrained: the widths
BI_STEPS, BI_REPLAY = 30, 3
# The cross-encoder from scratch at lr 3e-4 (the JAX package's recipe) sits
# near ln 2, the loss of predicting one half, for its first tens of steps:
# on the card its first batch's loss was above the first step's after 10
# steps and below it after 60.
CE_STEPS, DEC_STEPS, GROUNDED_STEPS = 60, 10, 5
TRAIN_BATCH, DEC_BATCH, GROUNDED_BATCH = 64, 16, 8
TRAIN_LR = 3e-4                    # pretrain.train_*'s default
# GroundedTrainer fine-tunes a converged checkpoint (nll about 0.05 a byte):
# Adam's first steps move every weight by about lr, and at train_grounded's
# 3e-4 that raised the first batch's nll in a CPU rehearsal of this phase;
# at 3e-5 it falls.
GROUNDED_LR = 3e-5
IDLE_STEPS = 3                     # steps traced for the idle share
CLI_TRAIN_STEPS = 20
N_TRAINED_EMBED = 64
# Card against CPU, both in bfloat16: each loss within 1e-2 relative (the
# tests' JAX-against-port bf16 tolerance); the grounded mixture's within
# 5e-2 (its copy attention amplifies bf16 flips; see slice_local_lm).
# Adam turns a gradient that is rounding noise into a step of about lr of
# either sign, so a weight may differ by what two runs' steps can add up
# to (adam_bound); the median difference within lr / 10.
TRAIN_LOSS_RTOL, GROUNDED_LOSS_RTOL = 1e-2, 5e-2
TRAINED_COSINE = 0.9999            # float16 storage against the trainer
TRAIN_KERNEL_PATHS = ("train_recall",)


def cpu_copy(params):
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


@contextlib.contextmanager
def recorded_trainer(mod, name, log, keep_after=()):
    """``mod.<name>`` (a trainer class) replaced by a subclass that keeps in
    ``log`` the trainer, a CPU copy of its first weights, each step's
    arguments, result and host ms (synchronised), and a CPU copy of its
    weights after each step count in ``keep_after``."""
    base = getattr(mod, name)

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            log.update(trainer=self, init=cpu_copy(self.params), steps=[],
                       after={})

        def train_step(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().train_step(*args)
            torch.cuda.synchronize()
            log["steps"].append({"args": args, "out": out, "ms": (
                time.perf_counter() - t0) * 1e3})
            if len(log["steps"]) in keep_after:
                log["after"][len(log["steps"])] = cpu_copy(self.params)
            return out
    setattr(mod, name, Recorded)
    try:
        yield
    finally:
        setattr(mod, name, base)


def step_stats(steps, model, tokens):
    """ms a step (median after the first), tokens a second, and model
    FLOPs utilisation: 6 x matmul parameters x tokens a step over 989
    TFLOP/s (dense bf16)."""
    ms = statistics.median(s["ms"] for s in steps[1:])
    toks = statistics.median(tokens(s["args"]) for s in steps)
    params = sum(m.weight.numel() for m in model.modules()
                 if isinstance(m, torch.nn.Linear))
    return {"steps": len(steps), "first_step_ms": steps[0]["ms"],
            "ms_per_step": ms, "tokens_per_step": toks,
            "tokens_per_s": toks / ms * 1e3, "matmul_params": params,
            "mfu": 6 * params * toks / (ms / 1e3) / PEAK_BF16}


def adam_bound(steps, max_weight, lr=TRAIN_LR, b1=0.9, b2=0.999,
               wd=1e-4):
    """The most two AdamW runs from the same weights can differ in one
    weight after ``steps`` steps: each step moves it by lr times
    |mu_hat| / sqrt(nu_hat) (at most sqrt(sum_i a_i^2 / c_i), Cauchy-Schwarz
    over the moments' weights a_i and c_i, 1 at the first step) plus lr *
    wd * |w|, in either direction in either run."""
    total = 0.0
    for t in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        c = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        total += math.sqrt(sum(x * x / y for x, y in zip(a, c)))
    return 2 * lr * (total + steps * wd * max_weight)


def hold_replay(what, card, cpu, rtol, card_w=None, cpu_w=None, steps=1):
    """The CPU's losses against the card's (relative ``rtol``) and, where
    given, its weights after ``steps`` steps (within ``adam_bound``, the
    median within lr / 10; the share beyond lr / 10 printed)."""
    rel = [abs(a - b) / abs(a) for a, b in zip(card, cpu)]
    if max(rel) > rtol:
        raise AssertionError(f"slice_train {what}: losses on the card "
                             f"{card}, on the CPU {cpu} (rtol {rtol})")
    rep = {"card": card, "cpu": cpu, "loss_rel_diff": max(rel),
           "loss_rtol": rtol}
    if card_w is not None:
        d = np.concatenate([(card_w[k] - cpu_w[k]).abs().numpy().ravel()
                            for k in card_w])
        bound = adam_bound(steps, max(float(w.abs().max())
                                      for w in card_w.values()))
        rep.update(weight_max_diff=float(d.max()),
                   weight_median_diff=float(np.median(d)),
                   weight_p999_diff=float(np.percentile(d, 99.9)),
                   weight_share_beyond_tenth_lr=float(
                       (d > TRAIN_LR / 10).mean()),
                   weight_bound=bound, weight_median_bound=TRAIN_LR / 10)
        if rep["weight_max_diff"] > bound or \
                rep["weight_median_diff"] > TRAIN_LR / 10:
            raise AssertionError(f"slice_train {what}: weights after {steps} "
                                 f"steps differ: {rep}")
    return rep


def loss_falls(what, log):
    """The loss of the run's first batch at the trained weights (a forward,
    no step) below the loss its first step reported."""
    trainer, first = log["trainer"], log["steps"][0]
    after = trainer.batch_loss(*first["args"])
    before, now = ((first["out"], after) if isinstance(after, float)
                   else (first["out"][0], after[0]))    # grounded: the nll
    if not now < before:
        raise AssertionError(f"slice_train {what}: the first batch's loss "
                             f"went from {before} to {now}")
    return {"first_batch_before": before, "first_batch_after": now,
            "step_losses": [s["out"] for s in log["steps"]]}


def train_report(log, tokens, dev):
    """Timings, idle share (IDLE_STEPS more steps of the last batches under
    the profiler) and peak memory of a recorded run."""
    steps = list(log["steps"])
    trainer = log["trainer"]
    rep = step_stats(steps, trainer.model, tokens)
    rep["device"] = device_busy(lambda: [trainer.train_step(*s["args"]) for s
                                         in steps[-IDLE_STEPS:]], cpu=False)
    rep["peak_device_gbytes"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return rep


def phase_slice_train(K_, T_, dev, chunks, work, smi):
    """Training on the card at the widths of the repo's checkpoints, from
    Flax-style initialisation seeded on the card, bf16 compute over float32
    master weights. (a) ``train_biencoder`` (checkpoints/pretrained's
    bi-encoder: 6 layers, 384 wide, vocab 32,768; max_len 64, batch 64) on
    the qa_docs chunks plus ``default_corpus()``, BI_STEPS steps, the loss
    falling; its first BI_REPLAY steps replayed on the CPU from the same
    weights and batches; a data=2 mesh of two logical devices on this card
    from the same seed. (b) ``train_cross_encoder`` at the settings'
    cross-encoder (4 layers, 384 wide) as ``train`` builds it and (c)
    ``train_decoder`` at checkpoints/pretrained's decoder (4 layers, 256
    wide, 1,024 positions, batch 16), each with its first step replayed
    on the CPU. (d) ``GroundedTrainer`` from checkpoints/grounded_r5
    (prompt 1,792, target 384, batch 8, GroundedSampler rows over the
    qa_docs chunks, lr GROUNDED_LR): step 0's nll and copy loss replayed
    on the CPU, each step's gradient norm before the clip printed (the
    clip scales the steps where it is 1 or more). Each trainer's loss
    falls: its first batch's loss at the trained weights is below the
    loss its first step reported. (e) The trained
    bi-encoder written with float16 storage, read back by
    ``load_biencoder`` on the card and held against the trainer's own
    forward over 64 training texts; a ``TrainCheckpointer`` save, restore
    into a fresh trainer and one more step against the uninterrupted step.
    (f)
    ``cli.main(["train", "--device", "cuda", ...])`` in process over a data
    directory of the qa_docs: its recall@10 lines, and the top-k kernels
    its DenseIndex searches launch, counted on the path ``train_recall``
    (the only part of ``train`` that searches) and held against their
    twins. Per trainer: ms a step, tokens a second, MFU, peak memory and
    the device's idle share. Returns the kernel records."""
    import io
    from optimized_rag_tpu_torch import cli
    from optimized_rag_tpu_torch.config import Settings
    from optimized_rag_tpu_torch.models import grounded as pg
    from optimized_rag_tpu_torch.models import pretrain, training
    from optimized_rag_tpu_torch.models.convert import (
        load_biencoder, load_config)
    from optimized_rag_tpu_torch.models.encoder import TransformerConfig
    from optimized_rag_tpu_torch.models.grounded_data import GroundedSampler
    from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
    from optimized_rag_tpu_torch.parallel.mesh import make_mesh
    from optimized_rag_tpu_torch.store.checkpoint import TrainCheckpointer
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    mesh, cpu_mesh = (make_mesh(data=1, devices=[d]) for d in (dev, cpu))
    texts = pretrain.default_corpus(chunks)
    rep = {"corpus_chunks": len(texts), "bf16_reduced_precision_reduction":
           torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
           "tf32": torch.backends.cuda.matmul.allow_tf32}

    # (a) The bi-encoder, its CPU replay and a data=2 mesh.
    cfg = load_config(TRAIN_CKPT, "biencoder")
    log = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_trainer(training, "BiEncoderTrainer", log,
                          keep_after=(BI_REPLAY,)):
        pretrain.train_biencoder(texts, cfg, mesh, steps=BI_STEPS,
                                 batch=TRAIN_BATCH, seed=SEED)
    losses = [s["out"] for s in log["steps"]]
    bi_tokens = lambda a: a[0].size + a[2].size  # noqa: E731
    bi = train_report(log, bi_tokens, dev)
    bi["loss"] = loss_falls("biencoder", log)
    t1 = time.perf_counter()
    replay = training.BiEncoderTrainer(cfg, cpu_mesh, learning_rate=TRAIN_LR,
                                       seed=SEED)
    replay.params = log["init"]
    bi["cpu_replay"] = hold_replay(
        "biencoder", losses[:BI_REPLAY],
        [replay.train_step(*s["args"]) for s in log["steps"][:BI_REPLAY]],
        TRAIN_LOSS_RTOL, log["after"][BI_REPLAY], replay.params, BI_REPLAY)
    bi["cpu_replay"]["seconds"] = time.perf_counter() - t1
    del replay
    log2 = {}
    with recorded_trainer(training, "BiEncoderTrainer", log2):
        pretrain.train_biencoder(texts, cfg, make_mesh(data=2,
                                                       devices=[dev, dev]),
                                 steps=BI_REPLAY, batch=TRAIN_BATCH,
                                 seed=SEED)
    if any(not torch.equal(log["init"][k], log2["init"][k])
           for k in log["init"]):
        raise AssertionError("slice_train: the seed's Flax init differs "
                             "between two runs on the card")
    bi["data2"] = hold_replay("biencoder data=2", losses[:BI_REPLAY],
                              [s["out"] for s in log2["steps"]],
                              TRAIN_LOSS_RTOL)
    del log2
    rep["biencoder"] = bi

    # (e) float16 storage read back by the agent's loader, then a
    # checkpointed step against the uninterrupted one.
    trainer = log["trainer"]
    out_dir = os.path.join(work, "train_out")
    pretrain.save_pretrained(out_dir, "biencoder", trainer.params, cfg,
                             store_dtype=np.float16)
    svc = load_biencoder(out_dir, device=dev)
    sample = texts[:N_TRAINED_EMBED]
    got = svc.encode(sample)
    ids, mask = HashTokenizer(cfg.vocab_size, svc.max_len).encode_batch(
        sample, svc.max_len)
    with torch.no_grad():
        own = trainer.model(torch.from_numpy(ids).long().to(dev),
                            torch.from_numpy(mask).to(dev)).float().cpu()
    cos = (torch.from_numpy(got) * own).sum(dim=1)
    if float(cos.min()) < TRAINED_COSINE:
        raise AssertionError(f"slice_train (e): float16 checkpoint against "
                             f"the trainer, cosine {float(cos.min())}")
    rep["float16_checkpoint"] = {"texts": len(sample),
                                 "min_cosine": float(cos.min()),
                                 "max_abs_diff": float(
                                     (torch.from_numpy(got) - own).abs().max()),
                                 "tolerance": TRAINED_COSINE}
    del svc
    ck = TrainCheckpointer(os.path.join(work, "train_ckpt"))
    done = len(log["steps"])
    t1 = time.perf_counter()
    ck.save(done, {"params": trainer.params, "opt_state": trainer.opt_state,
                   "step": done})
    save_s = time.perf_counter() - t1
    batch = log["steps"][0]["args"]
    whole = trainer.train_step(*batch)
    want = cpu_copy(trainer.params)
    del trainer, log
    resumed = training.BiEncoderTrainer(cfg, mesh, learning_rate=TRAIN_LR,
                                        seed=SEED + 1)
    state = ck.restore()
    resumed.params, resumed.opt_state = state["params"], state["opt_state"]
    again = resumed.train_step(*batch)
    diff = max(float((want[k] - v.cpu()).abs().max())
               for k, v in resumed.params.items())
    rep["checkpoint_resume"] = {
        "step": state["step"], "save_seconds": save_s,
        "loss_uninterrupted": whole, "loss_resumed": again,
        "bitwise": again == whole and diff == 0.0,
        "weight_max_diff": diff}
    if abs(again - whole) > 1e-6 * abs(whole) or diff > 2 * TRAIN_LR:
        raise AssertionError(f"slice_train (e): resumed step differs: "
                             f"{rep['checkpoint_resume']}")
    del resumed, state, want
    torch.cuda.empty_cache()

    # (b) The cross-encoder as ``train`` configures it, (c) the decoder.
    settings = Settings()
    ce = settings.cross_encoder
    ccfg = TransformerConfig(
        vocab_size=settings.encoder.vocab_size, hidden_dim=ce.hidden_dim,
        num_layers=ce.num_layers, num_heads=ce.num_heads,
        mlp_dim=ce.mlp_dim, max_seq_len=128)
    dcfg = pretrain.load_pretrained(TRAIN_CKPT, "decoder")[0]
    for what, cls, run in (
            ("crossencoder", "CrossEncoderTrainer",
             lambda: pretrain.train_cross_encoder(
                 texts, ccfg, mesh, steps=CE_STEPS, batch=TRAIN_BATCH,
                 seed=SEED)),
            ("decoder", "DecoderTrainer",
             lambda: pretrain.train_decoder(
                 texts, dcfg, mesh, steps=DEC_STEPS, batch=DEC_BATCH,
                 seed=SEED))):
        log = {}
        torch.cuda.reset_peak_memory_stats(dev)
        with recorded_trainer(training, cls, log, keep_after=(1,)):
            run()
        losses = [s["out"] for s in log["steps"]]
        r = train_report(log, lambda a: a[0].size, dev)
        r["loss"] = loss_falls(what, log)
        t1 = time.perf_counter()
        replay = getattr(training, cls)(
            ccfg if what == "crossencoder" else dcfg, cpu_mesh,
            learning_rate=TRAIN_LR, seed=SEED)
        replay.params = log["init"]
        r["cpu_replay"] = hold_replay(
            what, losses[:1], [replay.train_step(*log["steps"][0]["args"])],
            TRAIN_LOSS_RTOL, log["after"][1], replay.params, 1)
        r["cpu_replay"]["seconds"] = time.perf_counter() - t1
        rep[what] = r
        del replay, log
        torch.cuda.empty_cache()

    # (d) GroundedTrainer from the grounded_r5 weights.
    gcfg, gstate = pretrain.load_pretrained(LM_CKPT, "grounded",
                                            param_dtype=torch.float32)
    p_len, t_len = gcfg.prompt_len, gcfg.target_len
    sampler = GroundedSampler(chunks, prompt_len=p_len, target_len=t_len)
    rng = np.random.default_rng(SEED)
    log = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with recorded_trainer(pg, "GroundedTrainer", log):
        gt = pg.GroundedTrainer(gcfg, mesh, prompt_len=p_len,
                                target_len=t_len, learning_rate=GROUNDED_LR,
                                seed=SEED)
    gt.params = gstate
    norms = []
    for _ in range(GROUNDED_STEPS):
        gt.train_step(*sampler.batch(rng, GROUNDED_BATCH))
        norms.append(float(gt.last_grad_norm))
    g = {"prompt_len": p_len, "target_len": t_len, "batch": GROUNDED_BATCH,
         "pre_clip_grad_norms": norms, "clipped_steps": sum(
             n >= 1.0 for n in norms),
         **train_report(log, lambda a: a[0].size, dev)}
    g["loss"] = loss_falls("grounded", log)
    if not all(map(math.isfinite, norms)):
        raise AssertionError(f"slice_train (d): pre-clip norms {norms}")
    del gt
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    replay = pg.GroundedTrainer(gcfg, cpu_mesh, prompt_len=p_len,
                                target_len=t_len, learning_rate=GROUNDED_LR,
                                seed=SEED)
    replay.params = gstate
    g["cpu_replay"] = hold_replay(
        "grounded step 0", list(log["steps"][0]["out"]),
        list(replay.batch_loss(*log["steps"][0]["args"])),
        GROUNDED_LOSS_RTOL)
    g["cpu_replay"]["seconds"] = time.perf_counter() - t1
    rep["grounded"] = g
    del replay, log, gstate

    # (f) ``train`` from the CLI, its recall check's kernels counted.
    data = os.path.join(work, "train_data")
    agent = serving_agent(data, dev)
    agent.ingestor.upload_directory(QA_DOCS)
    agent.save_indexes()
    del agent
    torch.cuda.empty_cache()
    out = os.path.join(work, "train_cli")
    saved = os.environ.get("ORAG_DATA_DIR")
    os.environ["ORAG_DATA_DIR"] = data
    calls, paths, buf = [], {}, io.StringIO()
    t1 = time.perf_counter()
    try:
        with recording(T_, K_, calls), contextlib.redirect_stdout(buf):
            K_.reset_launch_counts()
            rc = cli.main(["train", "--device", dev.type, "--steps",
                           str(CLI_TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
                           "--out", out])
            paths["train_recall"] = K_.launch_counts()
    finally:
        if saved is None:
            os.environ.pop("ORAG_DATA_DIR", None)
        else:
            os.environ["ORAG_DATA_DIR"] = saved
    said = buf.getvalue()
    recall = re.search(r"synthetic recall@10: trained=([\d.]+) "
                       r"random-init=([\d.]+)", said)
    corpus = re.search(r"training corpus: (\d+) chunks \((\d+) ingested",
                       said)
    if rc != 0 or not recall or not corpus or int(corpus.group(2)) == 0 \
            or f"checkpoints -> {out}" not in said:
        raise AssertionError(f"slice_train (f): rc {rc}, {said[-1500:]!r}")
    seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
    if seen != paths["train_recall"]:
        raise AssertionError(f"slice_train: recorded {seen}, counted "
                             f"{paths['train_recall']}")
    if not sum(seen.values()):
        raise AssertionError("slice_train (f): train's recall check launched "
                             "no kernel")
    rep["cli_train"] = {"seconds": time.perf_counter() - t1, "rc": rc,
                        "steps": CLI_TRAIN_STEPS,
                        "corpus_chunks": int(corpus.group(1)),
                        "ingested_chunks": int(corpus.group(2)),
                        "recall_at_10_trained": float(recall.group(1)),
                        "recall_at_10_random_init": float(recall.group(2)),
                        "losses": [ln for ln in said.splitlines()
                                   if ln.startswith("losses:")]}
    held = hold_recorded(K_, T_, {p: calls for p in TRAIN_KERNEL_PATHS}, 5,
                         "slice_train")
    emit({"phase": "slice_train", "card": smi, **rep,
          "launches_by_path": paths, "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_train", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return held


# ---------------------------------------------------------------- eval tools

RESULTS = os.path.join(HERE, "docs", "results_r5")
EVAL_CLOCK = AGENT_CLOCK           # time.time() in the sheets, both runs
# Turns of the card's sheets the CPU replays (a seeded sample, in sheet
# order): the English sheet, the language sheets over the loopback
# endpoint, the same without translation; and of the --local-lm sheet.
EVAL_REPLAY = {"sheet_en": 6, "sheet_online": 5, "sheet_nt": 5}
EVAL_LM_REPLAY = 4
ROW_FIELDS = ("answer", "correct", "refused", "unanswerable",
              "citations_valid")
ROW_FLOATS = ("support_ratio", "factuality", "confidence")
# The gauntlet's rows and queries the CPU embeds again, held by cosine as
# the encoder tests hold the bf16 trunk (MIN_COSINE).
GAUNTLET_CPU_QUERIES, GAUNTLET_CPU_ROWS = 64, 256
GAUNTLET_POOL = 30_000             # run_gauntlet's pool_chunks default
EVAL_KERNEL_PATHS = ("eval_sheet", "eval_local_lm", "eval_gauntlet")
LANG_TAGS = ("pt", "es", "fr", "de")


def start_harvest():
    """``models/corpus.harvest_all`` as ``run_gauntlet`` calls it at its
    defaults, in a process of its own (no card): a deterministic host
    computation over the installed packages' sources (about 80 s of one
    core on the card's machine), started at slice_eval's start so that it
    overlaps (a)-(c) there, whose numbers are gates and not speeds, and no
    earlier phase. Returns (the process, its JSON's path)."""
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    path = os.path.join(HERE, "build", f"harvest-{os.getpid()}.json")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "from optimized_rag_tpu_torch.models.corpus import harvest_all\n"
            f"out = harvest_all(max_chunks={GAUNTLET_POOL}, "
            f"extra_dirs=[{HERE!r}])\n"
            f"with open({path!r}, 'w', encoding='utf-8') as f:\n"
            "    json.dump(out, f)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, path


def eval_sections(qa_sheet):
    """slice_eval's replayed sections: (name, sampled items, the id prefix
    ``main`` gives the section, ``build_agent``'s keywords, the Settings
    environment), then the --local-lm sheet's sampled items."""
    lang = [i for t in LANG_TAGS
            for i in getattr(qa_sheet, f"{t.upper()}_SHEET")]
    return (
        ("sheet_en", sampled(qa_sheet.QA_SHEET, EVAL_REPLAY["sheet_en"], 1),
         "", {}, None),
        ("sheet_online", sampled(lang, EVAL_REPLAY["sheet_online"], 2), "",
         {"online": True}, None),
        ("sheet_nt", sampled(lang, EVAL_REPLAY["sheet_nt"], 3), "nt-", {},
         {"ORAG_FLAGS_ENABLE_TRANSLATION": "0"})), sampled(
        qa_sheet.QA_SHEET, EVAL_LM_REPLAY, 4)


def eval_cpu_turns(work, out):
    """The CPU half of slice_eval (b) and (c), as ``start_eval_replay``'s
    process runs it: each sampled turn through a CPU agent built as the
    card's was (``build_agent(device="cpu")``, the loopback endpoint for
    the online section, translation off for ``nt-``, the grounded
    checkpoint for --local-lm), ``time.time`` pinned to EVAL_CLOCK, under
    the near-tie log (GenTieLog for --local-lm). Writes ``out``: each
    section's rows in order with the near-tie kinds each turn showed, and
    the seconds the sections took."""
    import tempfile
    from optimized_rag_tpu_torch.config import Settings
    from optimized_rag_tpu_torch.eval import qa_sheet
    from optimized_rag_tpu_torch.eval.llm_endpoint import MockOpenAIServer
    time.time = lambda: EVAL_CLOCK
    tempfile.tempdir = work        # the sheets' own data directories
    # Half the cores: the card's process and the harvest run beside it.
    torch.set_num_threads(max(1, torch.get_num_threads() // 2))
    got, t0 = {"seconds": {}}, time.perf_counter()

    def run(what, agent, items, prefix, tie_log):
        got[what] = []
        for item in items:
            with tie_log(agent) as ties:
                row = sheet_row(qa_sheet, agent, item, prefix)
            got[what].append({"row": row, "kinds": dict(ties.kinds)})
    sections, lm_items = eval_sections(qa_sheet)
    for what, items, prefix, kw, env in sections:
        data = os.path.join(work, f"cpu_{what}")
        with contextlib.ExitStack() as stack:
            if kw:
                server = stack.enter_context(MockOpenAIServer())
                stack.enter_context(environ(
                    ORAG_LLM_API_BASE=server.api_base))
            if env:
                settings = Settings.from_env(env)
                settings.data_dir = data
                agent = qa_sheet.build_agent(settings=settings, device="cpu")
            else:
                agent = qa_sheet.build_agent(data_dir=data, device="cpu",
                                             **kw)
            run(what, agent, items, prefix, TieLog)
        del agent
    got["seconds"]["sheets"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with environ(ORAG_LOCAL_LM_CKPT=LM_CKPT):
        agent = qa_sheet.build_agent(
            local_lm=True, data_dir=os.path.join(work, "cpu_lm"),
            device="cpu")
    run("local_lm", agent, lm_items, "", GenTieLog)
    got["seconds"]["local_lm"] = time.perf_counter() - t0
    with open(out, "w", encoding="utf-8") as f:
        json.dump(got, f)


def start_eval_replay(work):
    """``eval_cpu_turns`` in a process of its own (no card), started at
    slice_eval's start so that it runs beside the card's sheets. Returns
    (the process, its JSON's path)."""
    out = os.path.join(work, "cpu_turns.json")
    code = ("import sys\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "import chip_smoke\n"
            f"chip_smoke.eval_cpu_turns({work!r}, {out!r})\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=HERE,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                            stdout=sys.stderr)
    return proc, out


class Replayed:
    """``replay``'s ``ask`` and ``tie_log`` over turns another process
    ran (``eval_cpu_turns``): each ask hands out the next stored row, and
    the log then holds that turn's near-tie kinds."""

    def __init__(self, turns):
        self._turns, self.kinds = iter(turns), Counter()

    def __call__(self, _agent):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def ask(self, _item):
        turn_ = next(self._turns)
        self.kinds = Counter(turn_["kinds"])
        return turn_["row"]


@contextlib.contextmanager
def harvested(corpus, harvest):
    """``corpus.harvest_all`` answering ``run_gauntlet``'s default call
    from ``harvest`` (``start_harvest``'s process, waited for) and any
    other call as before."""
    proc, path = harvest
    if proc.wait() != 0:
        raise AssertionError(f"slice_eval (d): the harvest exited "
                             f"{proc.returncode}")
    with open(path, encoding="utf-8") as f:
        pool = json.load(f)
    os.remove(path)
    base = corpus.harvest_all

    def harvest_all(max_chunks=100000, seed=0, extra_dirs=None):
        if (max_chunks, seed) == (GAUNTLET_POOL, 0) and [
                os.path.realpath(d) for d in extra_dirs or ()] == [HERE]:
            return list(pool)
        return base(max_chunks, seed, extra_dirs)
    corpus.harvest_all = harvest_all
    try:
        yield len(pool)
    finally:
        corpus.harvest_all = base


def reference(name):
    with open(os.path.join(RESULTS, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def kg_numbers(tree):
    """Every precision, recall, tp, fp and fn of a kg_eval result, by
    path (the per-case lists left out)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update({f"{key}/{k}": v for k, v in kg_numbers(val).items()})
        elif key in ("precision", "recall", "tp", "fp", "fn"):
            out[key] = val
    return out


def row_differs(card, cpu):
    """The first field where two QA-sheet rows differ (floats beyond
    FLOAT_TOL), or None."""
    return next((f for f in ROW_FIELDS if card[f] != cpu[f]), None) or next(
        (f for f in ROW_FLOATS if not abs(card[f] - cpu[f]) <= FLOAT_TOL),
        None)


def sheet_row(qa_sheet, agent, item, prefix=""):
    """One item through ``run_sheet`` (its isolation included): its row,
    its id prefixed as ``main`` prefixes a section's."""
    row = qa_sheet.run_sheet(agent, sheet=[item], verbose=False)["rows"][0]
    return {**row, "id": prefix + row["id"]}


def sampled(items, n, salt):
    """``n`` items of a sheet, a seeded sample kept in sheet order."""
    keep = sorted(random.Random(SEED + salt).sample(range(len(items)), n))
    return [items[i] for i in keep]


@contextlib.contextmanager
def environ(**values):
    """The environment variables ``values`` set inside the block, each
    restored (or removed) after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_main(main, args, **env):
    """``main(args)`` with its stdout captured and ``env`` set for the call:
    (exit code, stdout)."""
    import io
    buf = io.StringIO()
    with environ(**env), contextlib.redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


def counted_calls(K_, T_, log, paths, name, fn):
    """``fn()`` with launch counts from 0 and every kernel call recorded
    under ``name`` (the recorded calls must equal the counts)."""
    calls = log.setdefault(name, [])
    with recording(T_, K_, calls):
        out = counted(K_, paths, name, fn)
    seen = {m: sum(c == m for c, _ in calls) for m in K_.KERNELS}
    if seen != paths[name]:
        raise AssertionError(f"slice_eval {name}: recorded {seen}, counted "
                             f"{paths[name]}")
    return out


def gauntlet_oracle(rows, queries, ids):
    """The card's dense top-k of each query against a float64 oracle over
    the card's own embeddings (unit rows; ties to the lower row): equal, or
    equal in score within TIE_TOL (a near-tie, counted)."""
    r = rows.astype(np.float64)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = ids.shape[1]
    out = {"queries": len(q), "equal": 0, "near_ties": 0}
    for i in range(0, len(q), 256):
        s = q[i:i + 256] @ r.T
        want = np.argsort(-s, axis=1, kind="stable")[:, :k]
        for j, (a, b) in enumerate(zip(ids[i:i + 256], want)):
            if (a == b).all():
                out["equal"] += 1
                continue
            got_s = np.sort(s[j, a])[::-1]
            if (a < 0).any() or np.abs(got_s - s[j, b]).max() > TIE_TOL:
                raise AssertionError(
                    f"slice_eval (d): query {i + j}: the card's ids {a}, the "
                    f"oracle's {b}, scores {got_s} against {s[j, b]}")
            out["near_ties"] += 1
    return out


def phase_slice_eval(K_, T_, dev, smi):
    """The eval tools on the card, as a user runs them. (a)
    ``kg_eval.main(["--loopback", ...])``: every precision, recall, tp, fp
    and fn equal to docs/results_r5/kg_eval.json's (host code). (b)
    ``qa_sheet.main(["--device", "cuda", "--no-translation-xl", ...])``:
    QA_SHEET over an agent built by ``build_agent`` (the in-repo encoders,
    the qa_docs), the four language sheets over an agent online to a
    loopback ``MockOpenAIServer``, the same four with translation
    disabled; EVAL_REPLAY turns of the three sections replayed on the
    CPU by agents built the same way, each row equal to the card's
    (floats within FLOAT_TOL) unless the CPU run shows a near-tie
    (counted). (c) ``main --local-lm`` with checkpoints/grounded_r5 over
    QA_SHEET, EVAL_LM_REPLAY turns replayed on the CPU (a differing answer
    excused only by a near-tie, a generation step's included). The CPU
    turns of (b) and (c) run in a process of their own
    (``start_eval_replay``) from this phase's start, beside the card's
    (a)-(d), and are held after (d). (d)
    ``encoder_gauntlet.run_gauntlet(device="cuda")`` at its defaults over
    this machine's harvest: GAUNTLET_CPU_QUERIES queries and
    GAUNTLET_CPU_ROWS index rows embedded again on the CPU (cosine
    MIN_COSINE), every dense top-10 against a float64 oracle over the
    card's embeddings (near-ties counted). The top-k kernels of (b), (c)
    and (d) are counted on the paths ``eval_sheet``, ``eval_local_lm`` and
    ``eval_gauntlet``. Summaries are printed beside the reference's
    comparable numbers (docs/results_r5; its headline accuracies include
    the pdf sections, absent here). ``time.time`` is pinned for (b) and
    (c). The gauntlet's harvest runs in a process of its own
    (``start_harvest``) from this phase's start, beside (a)-(c); the
    gauntlet waits for it. Returns the kernel records."""
    import shutil
    import tempfile
    from optimized_rag_tpu_torch.eval import (
        encoder_gauntlet, kg_eval, qa_sheet)
    from optimized_rag_tpu_torch.index.dense import DenseIndex
    from optimized_rag_tpu_torch.models.encoder import EmbeddingService
    from optimized_rag_tpu_torch.models import corpus, pretrain
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.mkdtemp(prefix="slice_eval-",
                            dir=os.path.join(HERE, "build"))
    rep, paths, log, counts = {}, {}, {}, {}
    cpu = "cpu"
    clock, tmp = time.time, tempfile.tempdir
    tempfile.tempdir = work        # the sheets' own data directories
    harvest = start_harvest()
    cpu_run = start_eval_replay(work)
    try:
        # (a) The KG eval, through the loopback endpoint too.
        t1 = time.perf_counter()
        out = os.path.join(work, "kg.json")
        rc, _ = run_main(kg_eval.main, ["--loopback", "--json", out])
        with open(out, encoding="utf-8") as f:
            got = kg_numbers(json.load(f))
        want = kg_numbers(reference("kg_eval"))
        if rc != 0 or got != want:
            bad = sorted(k for k in want if got.get(k) != want[k])
            raise AssertionError(f"slice_eval (a): rc {rc}; differs from "
                                 f"the reference at {bad}")
        rep["kg_eval"] = {"numbers_equal_reference": len(want),
                          "loopback": {k: v for k, v in got.items()
                                       if k.startswith("loopback")},
                          "seconds": time.perf_counter() - t1}

        # (b) The QA sheets on the card, then sampled turns on the CPU.
        time.time = lambda: EVAL_CLOCK
        t1 = time.perf_counter()
        out = os.path.join(work, "qa.json")
        rc, said = counted_calls(
            K_, T_, log, paths, "eval_sheet", lambda: run_main(
                qa_sheet.main, ["--device", dev.type, "--pdf-docs", "none",
                                "--no-translation-xl", "--json", out]))
        with open(out, encoding="utf-8") as f:
            card = json.load(f)
        rows = {r["id"]: r for r in card["rows"]}
        lang = [i for t in LANG_TAGS
                for i in getattr(qa_sheet, f"{t.upper()}_SHEET")]
        if rc != 0 or len(rows) != len(qa_sheet.QA_SHEET) + 2 * len(lang):
            raise AssertionError(f"slice_eval (b): rc {rc}, {len(rows)} rows")
        s = card["summary"]
        ref_full, ref_nt = reference("qa_full")["summary"], reference(
            "qa_nt")["summary"]
        keys = [f"{t}_{m}" for t in LANG_TAGS
                for m in ("accuracy", "probes_refused")]
        nt_keys = [f"{k}_notranslation" for k in keys]
        rep["sheet"] = {
            "seconds": time.perf_counter() - t1, "turns": len(rows),
            "summary": s,
            "reference_comparable": {
                k: {"card": s[k], "reference": (ref_full.get(k) if k in keys
                                                else ref_nt.get(k))}
                for k in keys + nt_keys},
            "not_comparable": {"answer_accuracy": s["answer_accuracy"],
                               "reference_with_pdf_sections":
                               ref_full["answer_accuracy"]}}

        # (c) --local-lm: the grounded generator writes the answers.
        t1 = time.perf_counter()
        out = os.path.join(work, "qa_lm.json")
        rc, said = counted_calls(
            K_, T_, log, paths, "eval_local_lm", lambda: run_main(
                qa_sheet.main, ["--device", dev.type, "--local-lm",
                                "--pdf-docs", "none", "--json", out],
                ORAG_LOCAL_LM_CKPT=LM_CKPT))
        with open(out, encoding="utf-8") as f:
            card = json.load(f)
        if rc != 0 or "loaded grounded checkpoint" not in said or len(
                card["rows"]) != len(qa_sheet.QA_SHEET):
            raise AssertionError(f"slice_eval (c): rc {rc}, {said[-500:]!r}")
        lm_rows = {r["id"]: r for r in card["rows"]}
        lm = {"seconds": time.perf_counter() - t1,
              "summary": card["summary"],
              "reference_with_pdf_sections": reference(
                  "qa_local_lm")["summary"]["answer_accuracy"]}
        time.time = clock

        # (d) The gauntlet at its defaults, its dense channel on the card.
        t1 = time.perf_counter()
        added, searched, encoded = [], [], {}
        add, search, encode = (DenseIndex.add, DenseIndex.search,
                               EmbeddingService.encode)

        def spy_add(self, emb):
            added.append(np.array(emb, np.float32))
            return add(self, emb)

        def spy_search(self, q, k, **kw):
            res = search(self, q, k, **kw)
            searched.append((np.array(q, np.float32), np.asarray(res.ids)))
            return res

        def spy_encode(self, texts):
            vecs = encode(self, texts)
            encoded.update(zip(texts, vecs))
            return vecs
        with harvested(corpus, harvest) as pool:
            wait_s = time.perf_counter() - t1
            DenseIndex.add, DenseIndex.search = spy_add, spy_search
            EmbeddingService.encode = spy_encode
            try:
                g = counted_calls(
                    K_, T_, log, paths, "eval_gauntlet",
                    lambda: encoder_gauntlet.run_gauntlet(device=dev))
            finally:
                DenseIndex.add, DenseIndex.search = add, search
                EmbeddingService.encode = encode
        g_s = time.perf_counter() - t1
        rows_, queries = np.concatenate(added), np.concatenate(
            [q for q, _ in searched])
        ids = np.concatenate([i for _, i in searched])
        if len(rows_) != g["index_size"] or len(queries) != g["n_queries"]:
            raise AssertionError(f"slice_eval (d): {len(rows_)} rows, "
                                 f"{len(queries)} queries for {g}")
        t1 = time.perf_counter()
        oracle = gauntlet_oracle(rows_, queries, ids)
        cfg, params = pretrain.load_pretrained(
            os.path.join(HERE, "checkpoints", "pretrained"), "biencoder")
        cpu_svc = EmbeddingService(
            cfg, params=params, max_len=64, cache_size=0, device=cpu,
            tokenizer=pretrain.load_tokenizer(
                os.path.join(HERE, "checkpoints", "pretrained"),
                cfg.vocab_size, 64))
        texts = list(encoded)
        pick = random.Random(SEED + 5)
        queries_t = [t for t in texts if len(t.split()) <= 8]
        sample = (pick.sample(queries_t, GAUNTLET_CPU_QUERIES)
                  + pick.sample([t for t in texts if len(t.split()) > 8],
                                GAUNTLET_CPU_ROWS))
        got = cpu_svc.encode(sample)
        cos = (got * np.stack([encoded[t] for t in sample])).sum(axis=1)
        if not cos.min() >= MIN_COSINE:
            raise AssertionError(f"slice_eval (d): CPU embeddings at cosine "
                                 f"{cos.min()} < {MIN_COSINE}")
        ref_g = reference("gauntlet")
        rep["gauntlet"] = {
            **g, "seconds": g_s, "harvest_wait_seconds": wait_s,
            "harvest_chunks": pool,
            "reference": {k: ref_g[k] for k in (
                "n_queries", "index_size", "recall_at_10_dense",
                "recall_at_1_dense", "recall_at_10_bm25")},
            "reference_comparable": False,
            "dense_oracle": oracle,
            "cpu_embeddings": {"texts": len(sample),
                               "min_cosine": float(cos.min()),
                               "tolerance": MIN_COSINE},
            "check_seconds": time.perf_counter() - t1}

        # The CPU's turns of (b) and (c), each held against the card's row.
        t1 = time.perf_counter()
        proc, cpu_out = cpu_run
        if proc.wait() != 0:
            raise AssertionError(f"slice_eval: the CPU replay exited "
                                 f"{proc.returncode}")
        with open(cpu_out, encoding="utf-8") as f:
            cpu_turns = json.load(f)
        wait_s = time.perf_counter() - t1
        sections, lm_items = eval_sections(qa_sheet)
        for what, items, prefix, _, _ in sections:
            done = Replayed(cpu_turns[what])
            replay(what, [rows[prefix + i.id] for i in items], None, items,
                   counts, phase="slice_eval", ask=done.ask,
                   differ=row_differs, tie_log=done, independent=True)
        rep["sheet"]["cpu_replay"] = {
            "seconds": cpu_turns["seconds"]["sheets"],
            **{w: counts[w] for w, *_ in sections}}
        done = Replayed(cpu_turns["local_lm"])
        replay("local_lm", [lm_rows[i.id] for i in lm_items], None,
               lm_items, counts, phase="slice_eval", ask=done.ask,
               differ=row_differs, tie_log=done, independent=True)
        lm["cpu_replay"] = {"seconds": cpu_turns["seconds"]["local_lm"],
                            "wait_seconds": wait_s, **counts["local_lm"]}
        rep["local_lm"] = lm
    finally:
        time.time, tempfile.tempdir = clock, tmp
        shutil.rmtree(work, ignore_errors=True)
        for proc in (harvest[0], cpu_run[0]):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    held = hold_recorded(K_, T_, {p: log.get(p, []) for p in
                                  EVAL_KERNEL_PATHS}, 5, "slice_eval")
    if not paths["eval_gauntlet"].get("tile_topk"):
        raise AssertionError(f"slice_eval (d): no K6 launch in the "
                             f"gauntlet's dense channel: {paths}")
    emit({"phase": "slice_eval", "card": smi, **rep,
          "launches_by_path": paths,
          "peak_device_gbytes": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})
    for rec in held:
        emit({"phase": "slice_eval", "card": smi, "kernel": rec["name"],
              **{key: v for key, v in rec.items() if key != "name"}})
    return held


# ------------------------------------------------- tensor parallelism

TP_STEPS, TP_BATCH, TP_LEN = 3, 64, 64
TP_DEC_BATCH, TP_GROUNDED_BATCH = 8, 2
TP_LOSS_RTOL = 1e-5                # float32 on both meshes


def tp_batches(chunks, cfg, n, rng):
    """``n`` bi-encoder batches of TP_BATCH (query span, its chunk) pairs
    of ``pretrain.default_corpus`` over the qa_docs, tokenised by the
    hashing tokenizer."""
    from optimized_rag_tpu_torch.models.pretrain import default_corpus
    from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
    tok = HashTokenizer(cfg.vocab_size, TP_LEN)
    chunks = default_corpus(chunks)
    out = []
    for _ in range(n):
        docs = [chunks[i] for i in rng.choice(len(chunks), TP_BATCH,
                                               replace=False)]
        spans = []
        for d in docs:
            w = d.split()
            at = int(rng.integers(0, max(len(w) - 8, 0) + 1))
            spans.append(" ".join(w[at:at + 8]))
        out.append((*tok.encode_batch(spans, TP_LEN),
                     *tok.encode_batch(docs, TP_LEN)))
    return out


def tp_copies(trainer):
    """(the data rows' copies, whether every copy's pieces and AdamW
    moments equal the first's bit for bit, the bytes of the first copy's
    parameters and both moments at each model position)."""
    from optimized_rag_tpu_torch.models.training import _flat
    flats = [_flat(pieces) for _, pieces in trainer._replicas]
    equal = all(torch.equal(p, flats[0][key]) and all(
        torch.equal(opt[m][key], trainer._opt[0][m][key])
        for m in ("mu", "nu"))
        for flat, opt in zip(flats[1:], trainer._opt[1:])
        for key, p in flat.items())
    held = {}
    for (_, i), p in flats[0].items():
        held[i] = held.get(i, 0) + 3 * p.numel() * p.element_size()
    return len(flats), equal, [held[i] for i in sorted(held)]


def tp_run(make, mesh_of, batches, lr):
    """A trainer per mesh (``make(mesh)``, the first mesh's weights copied
    to the rest), the same batches through each: per mesh the losses, the
    host ms of each step (synchronised), the peak memory, the final
    weights (on the CPU) and ``tp_copies``."""
    out = {}
    first = None
    for name, mesh in mesh_of.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = make(mesh)
        if first is None:
            first = cpu_copy(trainer.params)
        else:
            trainer.params = first
        losses, ms = [], []
        for args in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(trainer.train_step(*args))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        parts = {len(m.parts) for rep, _ in trainer._replicas
                 for m in rep.modules() if hasattr(m, "parts")}
        copies, equal, held = tp_copies(trainer)
        out[name] = {"losses": losses, "ms": ms, "parts": sorted(parts),
                     "copies": copies, "copies_equal": equal,
                     "bytes_by_model_position": held,
                     "peak_device_gbytes":
                     torch.cuda.max_memory_allocated() / 1e9,
                     "weights": cpu_copy(trainer.params), "lr": lr,
                     "data": mesh.shape["data"]}
        del trainer
    return out


def tp_hold(what, runs, steps):
    """Every mesh's run against the first's: losses within TP_LOSS_RTOL,
    weights within ``adam_bound`` over ``steps`` steps; the model>1 runs
    split in two parts; one copy per data row, all equal at the end; no
    model position holds as many bytes as model=1's one."""
    names = list(runs)
    base = runs[names[0]]
    rep = {}
    for name in names:
        r = runs[name]
        rel = max(abs(a - b) / abs(a) for a, b in zip(
            np.ravel(base["losses"]), np.ravel(r["losses"])))
        diff = max(float((base["weights"][k] - v).abs().max())
                   for k, v in r["weights"].items())
        bound = adam_bound(steps, max(float(w.abs().max()) for w in
                                      base["weights"].values()), lr=r["lr"])
        rep[name] = {"losses": r["losses"], "loss_rel_diff": rel,
                     "weight_max_diff": diff, "weight_bound": bound,
                     "ms_per_step": r["ms"], "parts": r["parts"],
                     "copies": r["copies"], "copies_equal": r["copies_equal"],
                     "bytes_by_model_position": r["bytes_by_model_position"],
                     "peak_device_gbytes": r["peak_device_gbytes"]}
        split = "model=2" in name
        whole = base["bytes_by_model_position"][0]
        if (rel > TP_LOSS_RTOL or diff > bound or (r["parts"] == [2]) != split
                or r["copies"] != r["data"] or not r["copies_equal"]
                or split != (max(r["bytes_by_model_position"]) < whole)):
            raise AssertionError(f"slice_tp {what} {name}: {rep[name]}")
    return rep


def phase_slice_tp(dev, chunks, smi):
    """Tensor parallelism for training on one card: both model positions
    (and both data rows) name ``cuda:0``, so every attention and MLP runs
    in two head (column) parts with two partial sums added, and each data
    row holds its own copy (the gradients summed across the copies and
    every copy stepping), which tests the code paths, not NVLink. In
    float32: (a) the bi-encoder at the
    bundled checkpoint's widths (384 wide, 6 layers, 12 heads, mlp 1,536,
    vocab 32,768; max_len 64, batch 64 of spans and chunks of
    ``default_corpus``),
    TP_STEPS steps at model=1, at data=1 x model=2 and at data=2 x
    model=2 (the same global batch); (b) the decoder at
    checkpoints/pretrained's widths (1,024 positions, batch TP_DEC_BATCH)
    and (c) GroundedTrainer from checkpoints/grounded_r5 (prompt 1,792,
    target 384, batch TP_GROUNDED_BATCH, the fused qkv split by heads in
    each third), one step each at model=1 and model=2. Losses within
    TP_LOSS_RTOL of model=1's, weights within ``adam_bound``; ms a step and
    the peak memory of each."""
    import dataclasses
    from optimized_rag_tpu_torch.models import grounded as pg
    from optimized_rag_tpu_torch.models import pretrain, training
    from optimized_rag_tpu_torch.models.convert import load_config
    from optimized_rag_tpu_torch.models.grounded_data import GroundedSampler
    from optimized_rag_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    f32 = lambda c: dataclasses.replace(c, dtype=torch.float32)  # noqa
    meshes = {"model=1": make_mesh(data=1, devices=[dev]),
              "data=1 model=2": make_mesh(data=1, model=2,
                                          devices=[dev] * 2),
              "data=2 model=2": make_mesh(data=2, model=2,
                                          devices=[dev] * 4)}
    rng = np.random.default_rng(SEED)
    cfg = f32(load_config(TRAIN_CKPT, "biencoder"))
    rep = {"biencoder": tp_hold("biencoder", tp_run(
        lambda m: training.BiEncoderTrainer(cfg, m, learning_rate=TRAIN_LR,
                                            seed=SEED),
        meshes, tp_batches(chunks, cfg, TP_STEPS, rng), TRAIN_LR), TP_STEPS)}
    rep["biencoder"]["config"] = {"hidden": cfg.hidden_dim, "layers":
                                  cfg.num_layers, "heads": cfg.num_heads,
                                  "mlp": cfg.mlp_dim, "batch": TP_BATCH,
                                  "max_len": TP_LEN}
    two = {k: meshes[k] for k in ("model=1", "data=1 model=2")}
    dcfg = f32(pretrain.load_pretrained(TRAIN_CKPT, "decoder")[0])
    ids = rng.integers(3, 259, (TP_DEC_BATCH, dcfg.max_seq_len)).astype(
        np.int32)
    ids[:, 0] = 1
    rep["decoder"] = tp_hold("decoder", tp_run(
        lambda m: training.DecoderTrainer(dcfg, m, learning_rate=TRAIN_LR,
                                          seed=SEED),
        two, [(ids,)], TRAIN_LR), 1)
    gcfg, gstate = pretrain.load_pretrained(LM_CKPT, "grounded",
                                            param_dtype=torch.float32)
    gcfg = f32(gcfg)
    sampler = GroundedSampler(chunks, prompt_len=gcfg.prompt_len,
                              target_len=gcfg.target_len)

    def grounded(mesh):
        trainer = pg.GroundedTrainer(
            gcfg, mesh, prompt_len=gcfg.prompt_len,
            target_len=gcfg.target_len, learning_rate=GROUNDED_LR,
            seed=SEED)
        trainer.params = gstate
        return trainer
    rep["grounded"] = tp_hold("grounded", tp_run(
        grounded, two, [sampler.batch(rng, TP_GROUNDED_BATCH)], GROUNDED_LR),
        1)
    emit({"phase": "slice_tp", "card": smi, **rep,
          "seconds": time.perf_counter() - t0})
    return max(r["peak_device_gbytes"] for v in rep.values()
               for r in v.values() if isinstance(r, dict)
               and "peak_device_gbytes" in r) * 1e9


SOURCES = {"packed_extract": ("optimized_rag_tpu_torch/csrc/packed_extract.cu",
                              "optimized_rag_tpu/ops/topk.py:511"),
           "extract": ("optimized_rag_tpu_torch/csrc/extract.cu",
                       "optimized_rag_tpu/ops/topk.py:992"),
           "tile_topk": ("optimized_rag_tpu_torch/csrc/tile_topk.cu",
                         "optimized_rag_tpu/ops/topk.py:142"),
           "packed_extract_int8": (
               "optimized_rag_tpu_torch/csrc/packed_extract.cu",
               "optimized_rag_tpu/ops/topk.py:548"),
           "extract_int8": ("optimized_rag_tpu_torch/csrc/extract.cu",
                            "optimized_rag_tpu/ops/topk.py:1037"),
           "tile_topk_scaled": ("optimized_rag_tpu_torch/csrc/tile_topk.cu",
                                "optimized_rag_tpu/ops/topk.py:178"),
           "packed_extract_scaled": (
               "optimized_rag_tpu_torch/csrc/packed_extract.cu",
               "optimized_rag_tpu/ops/topk.py:530"),
           "extract_scaled": ("optimized_rag_tpu_torch/csrc/extract.cu",
                              "optimized_rag_tpu/ops/topk.py:1021"),
           # F ports F1 (replaces) and F2, benchmarks/sweep_r4c.py:157,
           # the same function.
           "scan_floor": ("optimized_rag_tpu_torch/csrc/floor.cu",
                          "benchmarks/sweep_r4_kernel.py:128"),
           # K4p has no TPU kernel: it stands in for the whole tiled rerun
           # after a nonzero certificate.
           "extract_pairs": ("optimized_rag_tpu_torch/csrc/extract.cu",
                             "optimized_rag_tpu/ops/topk.py:1328")}


# The tensor-core scan: K1 and F over bf16/f16 rows, K2 over int8 codes and
# bf16 rows, K3.
MMA_SCAN_SOURCE = "optimized_rag_tpu_torch/csrc/scan_mma.cuh"
MMA_SCAN_ROWS = {"packed_extract": ("bf16", "f16"),
                 "scan_floor": ("bf16", "f16"),
                 "packed_extract_scaled": ("int8", "bf16"),
                 "packed_extract_int8": ("int8",)}


def kernel_entry(name, where, by_path, rec):
    """One entry of the final ``kernels`` line; the packed scans' and F's
    carry ``score_diff``, their largest score difference from the twin."""
    source, replaces = SOURCES[name]
    if where.split()[0] in MMA_SCAN_ROWS.get(name, ()):
        source = MMA_SCAN_SOURCE
    entry = {"name": f"{name}[{where}]", "route": "cuda", "source": source,
             "replaces": replaces, "launches": sum(by_path.values()),
             "launches_by_path": by_path,
             **{key: rec[key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")},
             "bound_share": rec["bound_ms"] / rec["ms"],
             "library_factor": rec["ms"] / rec["library_ms"]}
    if "score_diff" in rec:
        entry["score_diff"] = rec["score_diff"]
    if name == "scan_floor":
        entry["also_replaces"] = "benchmarks/sweep_r4c.py:157"
    return entry


FLOAT_KERNELS = ("packed_extract", "extract", "tile_topk")
INT8_KERNELS = ("packed_extract_int8", "extract_int8", "tile_topk_scaled")
USER_PATHS_F32 = ("served_burst", "served_closed_loop", "small_index")
USER_PATHS_BF16 = ("search", "small_index")
USER_PATHS_INT8 = ("served_burst", "served_closed_loop", "search",
                   "small_index")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    import optimized_rag_tpu_torch  # noqa: F401  (turns TF32 off)
    from optimized_rag_tpu_torch.ops import topk as T_
    from optimized_rag_tpu_torch.ops import topk_kernels as K_
    start_watchdog()
    kind, smi = phase_device()
    phase_build()
    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    phase_kernels(K_, T_, dev)
    chunks = qa_chunks()
    first = make_queries(chunks, random.Random(SEED))
    queries = (first, make_queries(chunks, random.Random(SEED + 1),
                                   exclude=set(first)))
    svc, index32, paths32, recs32, sel_tiles = phase_slice_f32(
        K_, T_, dev, chunks, queries)
    paths16, recs16 = phase_slice_bf16(K_, T_, dev, svc, index32, queries,
                                       sel_tiles)
    del index32
    torch.cuda.empty_cache()
    paths8, recs8 = phase_slice_int8(K_, T_, dev, svc, chunks, queries)
    peak = torch.cuda.max_memory_allocated()   # slice_hybrid resets it
    held_h, corpus_rows = phase_slice_hybrid(K_, T_, dev, svc, chunks,
                                             first[:N_HYBRID_QUERIES], smi)
    peak = max(peak, torch.cuda.max_memory_allocated())
    held_c = phase_slice_components(K_, T_, dev, svc, chunks, first,
                                    corpus_rows, smi)
    peak = max(peak, torch.cuda.max_memory_allocated())
    del svc, corpus_rows
    torch.cuda.empty_cache()
    held_a = phase_slice_agent(K_, T_, dev, chunks, smi)
    peak = max(peak, torch.cuda.max_memory_allocated())
    import shutil
    import tempfile
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="slice_serve-",
                            dir=os.path.join(HERE, "build"))
    try:
        held_s = phase_slice_serve(K_, T_, dev, chunks, queries, work, smi)
        peak = max(peak, torch.cuda.max_memory_allocated())
        data = os.path.join(work, "data")
        handed = list(phase_slice_ivf(K_, T_, dev, queries, data, smi))
        peak = max(peak, torch.cuda.max_memory_allocated())
        held_sh = phase_slice_sharded(K_, T_, dev, handed, queries, data,
                                      smi)
        peak = max(peak, torch.cuda.max_memory_allocated())
        phase_slice_local_lm(dev, chunks, work, smi)
        peak = max(peak, torch.cuda.max_memory_allocated())
        held_t = phase_slice_train(K_, T_, dev, chunks, work, smi)
        peak = max(peak, torch.cuda.max_memory_allocated())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    held_e = phase_slice_eval(K_, T_, dev, smi)
    peak = max(peak, torch.cuda.max_memory_allocated())
    peak = max(peak, phase_slice_tp(dev, chunks, smi))
    bench16, held16, bench8, held8 = phase_bench_shape(K_, T_, dev)
    peak = max(peak, torch.cuda.max_memory_allocated())
    emit({"phase": "done", "peak_device_gbytes": peak / 1e9,
          "seconds": time.perf_counter() - _T0})
    if peak > MAX_DEVICE_BYTES:
        raise AssertionError(f"peak device memory {peak / 1e9:.1f} GB "
                             f"> {MAX_DEVICE_BYTES / 1e9:.0f} GB")
    # One entry per kernel and shape a user path gives it, its numbers
    # measured at that shape and its launches counted on those paths alone:
    # the served slices (QueryServer rounds and the small index for f32;
    # DenseIndex.search at both sizes for bf16; QueryServer rounds,
    # DenseIndex.search and the small index for int8), then every shape of
    # bench_shape's routes, then each shape slice_hybrid's dense routes gave
    # K1, K4 and K6, then each shape slice_components' archival and restored
    # indexes gave K6, K1 and K4, then each shape slice_agent's chat turns
    # gave a kernel, then each shape slice_serve's /search and /chat gave
    # K6, then each shape slice_sharded's kernel searches gave K6 on a
    # shard, then each shape the recall check of slice_train's ``train``
    # gave a kernel, then each shape slice_eval's sheets and gauntlet gave
    # a kernel. The direct calls of the checks are not counted.
    kernels = []
    for dtype, paths, user, recs in (
            ("f32", paths32, USER_PATHS_F32, recs32),
            ("bf16", paths16, USER_PATHS_BF16, recs16),
            ("int8", paths8, USER_PATHS_INT8, recs8)):
        for name, rec in recs.items():
            kernels.append(kernel_entry(name, f"{dtype}", {
                p: paths[p][name] for p in user}, rec))
    for rec in held16 + held8:
        kernels.append(kernel_entry(
            rec["name"], f"{rec['dtype']} bench_shape {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_h:
        kernels.append(kernel_entry(
            rec["name"], f"{rec['dtype']} slice_hybrid {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_c:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_components N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_a:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_agent N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_s:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_serve N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_sh:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_sharded shard N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_t:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_train N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    for rec in held_e:
        kernels.append(kernel_entry(
            rec["name"],
            f"{rec['dtype']} slice_eval N={rec['N']} {rec['shape']}",
            rec["launches_by_path"], rec))
    idle = [k["name"] for k in kernels if not k["launches"]]
    missing = set(K_.KERNELS) - {k["name"].split("[")[0] for k in kernels}
    if idle or missing:
        raise AssertionError(f"never launched on a user path: {idle}; no "
                             f"entry: {sorted(missing)}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
