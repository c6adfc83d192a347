"""The qa_docs chunks' embeddings: the base rows of a ``"base": "qa_docs"``
corpus.

The plain float32 encoder (``portbench/reference/encoder.py``) embeds the
frozen chunks (``portbench/texts.py``) once, on the CPU, and
``qa_docs_rows.npy`` beside this file keeps them, so a run loads 42 rows
in place of spending its set-up on a second encoder. They are inputs: both
sides are handed the same rows, and the check reads them back from the
corpus. Remake the file after a change to the chunks, the checkpoint or
the encoder:

    python3 -m portbench.corpus.qa_docs_rows minilm-l6.f32-4m

``portbench/tests/test_portbench_reference.py`` holds the file to the
encoder.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "qa_docs_rows.npy")


def encode(cfg: dict) -> np.ndarray:
    """The chunks' unit rows [n_chunks, hidden] by the plain float32
    encoder of ``cfg``, on the CPU."""
    from portbench import system, texts
    model, tok = system.reference_encoder(cfg, "cpu")
    return model.encode(tok, texts.chunks(),
                        int(cfg["encoder"]["max_len"])).numpy()


def load(device) -> torch.Tensor:
    return torch.from_numpy(np.load(PATH)).to(device)


def main(argv) -> int:
    from portbench import harness
    bench = harness.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == argv[0])
    rows = encode(harness.load_json(harness.ROOT, entry["file"]))
    np.save(PATH, rows.astype(np.float32))
    print(f"wrote {rows.shape[0]} x {rows.shape[1]} rows to {PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
