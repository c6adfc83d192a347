"""Kimi Delta Attention (KDA) in chunks: the prefill's chunked form of the
gated delta rule, and its walk over chunks (``csrc/kda_chunk.cu``).

There is no counterpart in the JAX package: the JAX package computes no
recurrence. The layer is ``models/kimi_linear.KDA``. Per head, with keys
and queries of ``d_k`` and values of ``d_v`` channels, a state
``S`` [d_k, d_v] in float32 and per token a log-decay ``g`` [d_k] (at or
below 0) and a rate ``beta``::

    S <- Diag(exp g_t) S
    S <- S + beta_t k_t (v_t - S^T k_t)^T
    o_t = S^T q_t

**The chunked form.** Over a chunk of C tokens from state ``S_0``, with
``G_r`` the cumulative sum of ``g`` to position r inside the chunk, and
every decay a difference ``G_a - G_b`` with a at or after b (so that no
``exp`` of a positive sum can overflow)::

    A_kk[r, s] = sum_c k_rc k_sc exp(G_rc - G_sc)     s < r
    A_qk[r, s] = sum_c q_rc k_sc exp(G_rc - G_sc)     s <= r
    (I + Diag(beta) A_kk) [W | U] = Diag(beta) [k exp(G) | v]
    u'  = U - W S_0
    o   = (q exp(G)) S_0 + A_qk u'
    S_C = Diag(exp G_C) S_0 + (k exp(G_C - G))^T u'

``chunk_tensors`` computes everything before the walk in torch, batched
over all the chunks of a prefill chunk at once. The pairwise decays of
``A_kk`` and ``A_qk`` are never formed as a [C, C, d_k] tensor: the pairs
of a chunk fall into halves, quarters, ... of it, and the pairs (upper
half, lower half) of a block of 2m positions are one product of
``q exp(G - G_m)`` by ``k exp(G_m - G)``, ``G_m`` taken at the first
position of the upper half, both exponents at or below 0.

**The walk** (``chunk_state``): every segment's chunks in order from its
initial state, carried in and out through ``state`` [B, h, d_k, d_v].
On the card it is ``kda::chunk_state_kernel``; a CPU tensor takes its
plain twin, ``chunk_state_plain``, the same pass in torch.
"""

from __future__ import annotations

import threading

import torch

CHUNK = 64

_counts_lock = threading.Lock()
_launches = {"chunk_state": 0}


def launch_counts() -> dict:
    with _counts_lock:
        return dict(_launches)


def layout(lengths, device):
    """Where each of the segments' tokens (packed in order, ``lengths``
    each) lies in the chunked layout: (slot [T] on ``device``, the first
    chunk of each segment and the end [S + 1] on the host, the chunk
    count). A segment starts a chunk; its last chunk is padded."""
    offsets, n = [0], 0
    for t in lengths:
        n += -(-t // CHUNK)
        offsets.append(n)
    slot = torch.cat([torch.arange(o * CHUNK, o * CHUNK + t, device=device)
                      for o, t in zip(offsets, lengths)])
    return slot, offsets, n


def pack(x, slot, chunks: int, heads: int):
    """Token rows ``x`` [T, h * d] into float32 [N, h, C, d] chunks, the
    pad positions 0."""
    d = x.shape[-1] // heads
    out = x.new_zeros(chunks * CHUNK, x.shape[-1])
    out.index_copy_(0, slot, x)
    dst = torch.empty(chunks, heads, CHUNK, d, dtype=torch.float32,
                      device=x.device)
    return dst.copy_(out.view(chunks, CHUNK, heads, d).transpose(1, 2))


def unpack(o, slot):
    """[N, h, C, d] chunks back to token rows [T, h, d]."""
    n, h, c, d = o.shape
    return o.transpose(1, 2).reshape(n * c, h, d).index_select(0, slot)


def pair_blocks(q, k, G):
    """(A_kk strictly lower, A_qk lower with its diagonal) [M, C, C] of
    chunks q, k and cumulative log-decays G [M, C, d] (module
    docstring)."""
    m, c, d = k.shape
    akk = q.new_zeros(m, c, c)
    aqk = q.new_zeros(m, c, c)
    aqk.diagonal(dim1=1, dim2=2).copy_((q * k).sum(-1))
    s = c // 2
    while s >= 1:
        nb = c // (2 * s)
        gb = G.view(m, nb, 2, s, d)
        ref = gb[:, :, 1, :1]
        up = (gb[:, :, 1] - ref).exp_()
        lo = (ref - gb[:, :, 0]).exp_().mul_(k.view(m, nb, 2, s, d)[:, :, 0])
        lo = lo.transpose(-1, -2)
        for a, x in ((aqk, q), (akk, k)):
            blk = torch.matmul(x.view(m, nb, 2, s, d)[:, :, 1] * up, lo)
            a.view(m, nb, 2 * s, nb, 2 * s).diagonal(dim1=1, dim2=3)[
                :, s:, :s] = blk.permute(0, 2, 3, 1)
        s //= 2
    return akk, aqk


def chunk_tensors(q, k, v, g, beta):
    """The walk's inputs of chunks ``q``, ``k`` [M, C, d_k], ``v`` [M, C,
    d_v], ``g`` [M, C, d_k] and ``beta`` [M, C] (all float32; pad positions
    0): ([W | U] [M, C, d_k + d_v], q exp(G), A_qk, k exp(G_C - G),
    exp(G_C)), each contiguous."""
    G = g.cumsum(1)
    eg = G.exp()
    last = G[:, -1:]
    kh = (last - G).exp_().mul_(k)
    gam = last[:, 0].exp()
    akk, aqk = pair_blocks(q, k, G)
    del G
    lower = akk.mul_(beta[..., None])
    rhs = torch.cat([k * eg, v], dim=-1).mul_(beta[..., None])
    # Solved as [W | U]^T (I + Diag(beta) A_kk)^T = rhs^T: the solver
    # returns its result column-major, so [W | U] comes out row-major.
    wu = torch.linalg.solve_triangular(
        lower.transpose(-1, -2), rhs.transpose(-1, -2), upper=True,
        left=False, unitriangular=True).transpose(-1, -2)
    del lower, rhs
    return wu.contiguous(), eg.mul_(q), aqk, kh, gam


def chunk_state_plain(wu, qt, aqk, kh, gam, offsets, rows, state):
    """The walk in torch: chunks [N, h, C, d] of segment i are
    ``offsets[i]`` to ``offsets[i + 1] - 1``, its state ``state[rows[i]]``
    [h, d_k, d_v] (read first, written last) -> o [N, h, C, d_v]."""
    w, u = wu.split([qt.shape[-1], state.shape[-1]], dim=-1)
    o = torch.empty_like(u)
    for i, row in enumerate(rows):
        s = state[row].clone()
        for n in range(offsets[i], offsets[i + 1]):
            un = u[n] - w[n] @ s
            o[n] = qt[n] @ s + aqk[n] @ un
            s = gam[n][..., None] * s + kh[n].transpose(-1, -2) @ un
        state[row] = s
    return o


def _host_ints(values, device):
    t = torch.tensor(values, dtype=torch.int32)
    return t.pin_memory().to(device, non_blocking=True)


def chunk_state(wu, qt, aqk, kh, gam, offsets, rows, state):
    """The walk (``chunk_state_plain``'s arguments): the kernel on the
    card, the twin on the CPU. ``offsets`` and ``rows`` are host lists; a
    row appears once."""
    if wu.device.type == "cpu":
        return chunk_state_plain(wu, qt, aqk, kh, gam, offsets, rows, state)
    n, h, c, dk = qt.shape
    dv = state.shape[-1]
    if (c, dk, dv) != (CHUNK, 128, 128) or not rows:
        raise ValueError(f"chunk_state: chunks [{n}, {h}, {c}, {dk}], "
                         f"values {dv}; the kernel takes C=64, d_k=d_v=128")
    for name, t, shape in (("wu", wu, (n, h, c, dk + dv)),
                           ("qt", qt, (n, h, c, dk)),
                           ("aqk", aqk, (n, h, c, c)),
                           ("kh", kh, (n, h, c, dk)),
                           ("gam", gam, (n, h, dk)),
                           ("state", state, (state.shape[0], h, dk, dv))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != qt.device):
            raise ValueError(f"chunk_state: {name} {tuple(t.shape)} "
                             f"{t.dtype}, want {shape} float32, contiguous, "
                             f"on {qt.device}")
    if (len(offsets) != len(rows) + 1 or offsets[0] < 0 or offsets[-1] > n
            or any(b < a for a, b in zip(offsets, offsets[1:]))
            or len(set(rows)) != len(rows)
            or not all(0 <= r < state.shape[0] for r in rows)):
        raise ValueError("chunk_state: offsets or rows out of range")
    from optimized_rag_tpu_torch.ops._build import load_library
    lib = load_library()
    off_t = _host_ints(offsets, qt.device)
    rows_t = _host_ints(rows, qt.device)
    o = torch.empty(n, h, c, dv, dtype=torch.float32, device=qt.device)
    with torch.cuda.device(qt.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kda_chunk_state(
            wu.data_ptr(), qt.data_ptr(), aqk.data_ptr(), kh.data_ptr(),
            gam.data_ptr(), off_t.data_ptr(), rows_t.data_ptr(),
            state.data_ptr(), o.data_ptr(), len(rows), h, stream)
    if err != 0:
        raise RuntimeError(f"kda chunk_state kernel launch failed: "
                           f"{lib.orag_error_string(err).decode()}")
    with _counts_lock:
        _launches["chunk_state"] += 1
    return o
