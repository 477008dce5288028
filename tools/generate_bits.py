#!/usr/bin/env python3
"""Print a sha256 of ``generate``'s tokens and logits for the source tree
at ROOT (default: this checkout), on the CPU, to show that two trees give
the same bits on the one-device path.

    python3 tools/generate_bits.py [ROOT]

Reduced yi-6b, dbrx-132b and gemma2-2b (fp32, weights drawn from seed 3,
a (2, 24) prompt from seed 0), each through the full cache (``buf_len``
32) and through the ring in chunks (``buf_len`` 19, window 16, chunk 4),
6 new tokens, greedy, on one torch thread. One line a case: ``<arch>
<mode> <sha256>``. Run it on a parent and on a change and compare the
lines; it imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import os
import sys

ROOT = sys.argv[1] if len(sys.argv) > 1 else \
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import generate  # noqa: E402

MODES = {"full": dict(buf_len=32),
         "ring": dict(buf_len=19, window=16, chunk=4)}


def main():
    torch.set_num_threads(1)
    for arch in ("yi-6b", "dbrx-132b", "gemma2-2b"):
        cfg = reduced(get_arch(arch))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                   (2, 24))
        for mode, kw in MODES.items():
            toks, logits = generate(model, params, {"tokens": tokens},
                                    max_new_tokens=6, **kw)
            digest = hashlib.sha256(toks.numpy().tobytes()
                                    + logits.numpy().tobytes()).hexdigest()
            print(arch, mode, digest)


if __name__ == "__main__":
    main()
