"""Serving launcher: the continuous-batching engine over seeded requests.

    python -m repro_torch.launch.serve --arch qwen1.5-0.5b [--smoke] \
        [--n-requests 6] [--lanes 2] [--max-new-tokens 8] [--device cpu]

Counterpart of ``repro.launch.serve``, with the same flags and requests,
plus ``--device`` (default: the card; without one it raises unless given
``--device cpu``).  ``--arch`` takes the models the port serves: the dense
attention configs (``qwen1.5-0.5b``, ``llama3.2-3b``, ``yi-9b``),
``minicpm3-4b`` (MLA latent attention; one H100 holds it whole),
``xlstm-350m``, ``mixtral-8x7b`` (sliding-window attention, all 8
experts), and the cuts one H100 serves: ``jamba-1.5-large`` (one
supercell at full width holding 8 of its 16 experts) and
``mixtral-8x7b-ep2`` (all 32 layers at full width holding 4 of its 8
experts).  ``--smoke`` gives a narrow model of the same kind for the CPU.
Weights are random, from the port's seeded ``init_params``, drawn straight
into the served type.  The engine refuses an encoder-decoder config, as
the reference's does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import init_params
from ..serve.engine import Request, ServeEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-requests", type=int, default=6)
    ap.add_argument("--lanes", type=int, default=2)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev, serve=True)
    eng = ServeEngine(params, cfg, n_lanes=args.lanes, max_len=96,
                      device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab, size=rng.integers(4, 16)),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.n_requests)]
    done = eng.run(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {len(r.prompt)} prompt toks -> {r.out_tokens}")


if __name__ == "__main__":
    main()
