"""Plain float32 forward of the checkpoint's bi-encoder, from its npz.

The function is the checkpoint's own (a MiniLM-L6-shaped trunk, as the
repository trains it), written out with plain ``torch`` operations and no
code of the program: token, position and type embeddings, then LayerNorm;
six pre-LayerNorm blocks of 12-head self-attention and a GELU (tanh) MLP,
each added back to its input; a final LayerNorm; the mean over real
tokens; a 384 x 384 projection; L2 normalisation. LayerNorm eps is 1e-6.
Departures from the published all-MiniLM-L6-v2 are listed in the
configuration file. The weights are read from the npz as data (float16
there, exact in float32), and every matmul runs in float32 with TF32 off.

``dtype=torch.float64`` runs the same function in float64 (the tests hold
the float32 forward to it). ``matmul_dtype=torch.float8_e4m3fn`` is the
control: each matmul's two inputs are rounded to fp8 (per-tensor scale,
amax to 448) before a float32 product, the step below the bfloat16 the
configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-6
_FP8_MAX = 448.0


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Encoder:
    def __init__(self, npz: dict[str, np.ndarray], num_layers: int,
                 num_heads: int, device, matmul_dtype=torch.float32,
                 dtype=torch.float32):
        self.device = torch.device(device)
        self.heads = num_heads
        self.matmul_dtype = matmul_dtype
        self.dtype = dtype
        t = lambda k: torch.from_numpy(                  # noqa: E731
            np.asarray(npz[k], np.float64)).to(self.device, dtype)
        p = "params/trunk/"
        self.tok = t(p + "emb/tok/embedding")
        self.pos = t(p + "emb/pos/embedding")
        self.typ = t(p + "emb/typ/embedding")
        self.ln_e = (t(p + "emb/ln/scale"), t(p + "emb/ln/bias"))
        self.ln_f = (t(p + "ln_f/scale"), t(p + "ln_f/bias"))
        h = self.tok.shape[1]
        self.blocks = []
        for i in range(num_layers):
            b = f"{p}block_{i}/"

            def dense(name, shape, b=b):
                return (t(b + name + "/kernel").reshape(shape),
                        t(b + name + "/bias").reshape(-1))
            self.blocks.append({
                "ln1": (t(b + "ln1/scale"), t(b + "ln1/bias")),
                "ln2": (t(b + "ln2/scale"), t(b + "ln2/bias")),
                "q": dense("attn/query", (h, h)),
                "k": dense("attn/key", (h, h)),
                "v": dense("attn/value", (h, h)),
                "o": dense("attn/out", (h, h)),
                "mlp_in": dense("mlp_in", (h, -1)),
                "mlp_out": dense("mlp_out", (-1, h)),
            })
        self.proj = (t("params/proj/kernel"), t("params/proj/bias"))

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.matmul_dtype == torch.float8_e4m3fn:
            a, b = _fp8(a), _fp8(b)
        return a @ b

    def _dense(self, x, wb):
        return self._mm(x, wb[0]) + wb[1]

    @staticmethod
    def _ln(x, sb):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + _EPS) * sb[0] + sb[1]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[n, L] ids and mask -> [n, 384] unit vectors (``dtype``)."""
        n, length = ids.shape
        x = self.tok[ids] + self.pos[:length][None] + self.typ[0]
        x = self._ln(x, self.ln_e)
        keep = mask.bool()[:, None, None, :]
        hd = x.shape[-1] // self.heads
        split = lambda y: y.view(  # noqa: E731
            n, length, self.heads, hd).transpose(1, 2)
        for blk in self.blocks:
            y = self._ln(x, blk["ln1"])
            q, k, v = (split(self._dense(y, blk[w])) for w in "qkv")
            w = self._mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
            w = torch.softmax(w.masked_fill(~keep, float("-inf")), dim=-1)
            o = self._mm(w, v).transpose(1, 2).reshape(n, length, -1)
            x = x + self._dense(o, blk["o"])
            y = self._ln(x, blk["ln2"])
            g = torch.nn.functional.gelu(self._dense(y, blk["mlp_in"]),
                                         approximate="tanh")
            x = x + self._dense(g, blk["mlp_out"])
        x = self._ln(x, self.ln_f)
        m = mask.to(x.dtype)[..., None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
        out = self._dense(pooled, self.proj)
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-9)

    @torch.no_grad()
    def encode(self, tokenizer, texts: list[str], max_len: int,
               batch: int = 256) -> torch.Tensor:
        """Unit vectors [len(texts), 384] (``dtype``) on the device, in
        blocks of ``batch`` texts."""
        out = []
        for lo in range(0, len(texts), batch):
            ids, mask = tokenizer.encode_batch(texts[lo:lo + batch], max_len)
            out.append(self.forward(torch.from_numpy(ids).to(self.device),
                                    torch.from_numpy(mask).to(self.device)))
        return torch.cat(out)
