"""Batched serving on the port with continuous batching: more requests than
cache lanes, per-lane isolation, greedy decoding.

    PYTHONPATH=src python examples/torch_serve_decode.py
    PYTHONPATH=src python examples/torch_serve_decode.py --smoke --device cpu

The port of ``examples/serve_decode.py``: 2 lanes of 64 positions, five
requests of 5, 9, 7, 12 and 4 tokens drawn from ``default_rng(0)``, 8 new
tokens each.  By default it serves ``qwen1.5-0.5b`` at full width (24
layers, d_model 1024, 16 heads of 64, bf16), the model the port serves on
the card.  ``--smoke`` gives the reference's exact example, the model's
smoke config (2 layers, d_model 64, 4 heads of 64, vocab 256), on the
CPU or on the card.  On the card every prefill goes through the
flash-attention kernel and every decode step through the flash-decode
kernel, whose instances take heads 64 and 128 wide.  Weights are random,
from the port's seeded ``init_params``.  Without a card it raises unless
given ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serve.engine import Request, ServeEngine

PROMPT_LENS = (5, 9, 7, 12, 4)


def main(argv=None) -> list[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("qwen1.5-0.5b", smoke=args.smoke)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev, serve=True)
    eng = ServeEngine(params, cfg, n_lanes=2, max_len=64, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=ln),
                    max_new_tokens=8)
            for i, ln in enumerate(PROMPT_LENS)]
    done = eng.run(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    assert len(done) == len(reqs)
    return done


if __name__ == "__main__":
    main()
