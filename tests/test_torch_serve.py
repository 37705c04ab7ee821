"""The port's serving engine (``repro_torch.serve``) against the
reference's (``repro.serve``) on the same weights, on the CPU: equal tokens
on the same requests under an f32 config, the three behaviours of
tests/test_serve.py, idle lanes whose lengths run past ``max_len``, and the
launcher.  The reference engine ``vmap``s a one-lane decode; the port
decodes its lanes as one batch with per-lane lengths.
"""
import ast

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import greedy_generate, init_params
from repro_torch.serve.engine import Request, ServeEngine


@pytest.fixture(scope="module")
def setup():
    """f32 smoke Qwen: the reference's and the port's config and weights."""
    jcfg = j_get_config("qwen1.5-0.5b", smoke=True).replace(dtype="float32")
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(dtype="float32")
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, cfg, convert.params_from(jax.tree.map(np.asarray, jp),
                                              cfg)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def port(request):
    """The port's smoke Qwen in f32 and in bf16 (the reference tests'
    type), on the reference's weights."""
    jcfg = j_get_config("qwen1.5-0.5b", smoke=True)
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(dtype=request.param)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    return cfg, convert.params_from(jax.tree.map(np.asarray, jp), cfg)


def _both(setup, prompts, new_tokens, n_lanes, max_len):
    """Run the same requests through both engines; return both token lists."""
    jcfg, jp, cfg, p = setup
    jreqs = [JRequest(rid=i, prompt=np.asarray(pr, np.int32),
                      max_new_tokens=n) for i, (pr, n) in
             enumerate(zip(prompts, new_tokens))]
    reqs = [Request(rid=i, prompt=np.asarray(pr, np.int32), max_new_tokens=n)
            for i, (pr, n) in enumerate(zip(prompts, new_tokens))]
    jdone = JServeEngine(jp, jcfg, n_lanes=n_lanes, max_len=max_len).run(
        jreqs)
    done = ServeEngine(p, cfg, n_lanes=n_lanes, max_len=max_len,
                       device="cpu").run(reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(r.done for r in done)
    return [r.out_tokens for r in jreqs], [r.out_tokens for r in reqs]


def test_engine_matches_reference_engine(setup):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, size=n) for n in (4, 9, 15, 6, 11)]
    want, got = _both(setup, prompts, [5, 3, 6, 4, 5], n_lanes=2,
                      max_len=48)
    assert got == want


def test_idle_lane_length_past_max_len(setup):
    """Lane 0 retires early with a long prompt and idles while lane 1 runs
    on, so lane 0's length passes max_len: the write index clamps (as the
    reference's dynamic_update_slice does) and lane 1 is not disturbed."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=12), rng.integers(1, 256, size=2)]
    cfg = setup[2]
    eng = ServeEngine(setup[3], cfg, n_lanes=2, max_len=16, device="cpu")
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=n)
            for i, (pr, n) in enumerate(zip(prompts, [2, 100]))]
    eng.run(reqs)
    assert int(eng.lengths[0]) > eng.max_len
    want, got = _both(setup, prompts, [2, 100], n_lanes=2, max_len=16)
    assert got == want
    solo = Request(rid=0, prompt=prompts[1], max_new_tokens=100)
    ServeEngine(setup[3], cfg, n_lanes=1, max_len=16, device="cpu").run(
        [solo])
    assert got[1] == solo.out_tokens


# -- the three behaviours of tests/test_serve.py ---------------------------
def test_single_request_matches_greedy(port):
    cfg, p = port
    prompt = np.arange(1, 9, dtype=np.int32)
    want = greedy_generate(p, cfg, torch.from_numpy(prompt)[None], steps=6,
                           max_len=64, device="cpu")
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=64, device="cpu")
    req = Request(rid=0, prompt=prompt, max_new_tokens=6)
    done = eng.run([req])
    assert done[0].done
    assert want[0].tolist() == req.out_tokens


def test_batched_requests_isolated(setup):
    """Concurrent lanes must not contaminate each other's outputs."""
    _, _, cfg, p = setup
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(11, 23, dtype=np.int32),
               np.full(5, 7, dtype=np.int32)]
    solo = []
    for pr in prompts:
        r = Request(rid=0, prompt=pr, max_new_tokens=5)
        ServeEngine(p, cfg, n_lanes=1, max_len=64, device="cpu").run([r])
        solo.append(list(r.out_tokens))
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=5)
            for i, pr in enumerate(prompts)]
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=64, device="cpu")
    done = eng.run(reqs)
    assert len(done) == 3
    for r in reqs:
        assert r.out_tokens == solo[r.rid], r.rid


def test_more_requests_than_lanes(port):
    cfg, p = port
    reqs = [Request(rid=i, prompt=np.arange(1, 6, dtype=np.int32),
                    max_new_tokens=3) for i in range(5)]
    eng = ServeEngine(p, cfg, n_lanes=2, max_len=32, device="cpu")
    done = eng.run(reqs)
    assert len(done) == 5
    assert all(len(r.out_tokens) == 3 for r in reqs)
    st = eng.stats
    assert st["prefill_tokens"] == 25 and st["decode_tokens"] == 10
    assert st["decode_steps"] >= 5 and st["decode_s"] > 0


# -- device policy and the launcher ----------------------------------------
def test_engine_and_launcher_need_a_card_unless_cpu(monkeypatch, capsys):
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(p, cfg, n_lanes=2, max_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--smoke"])
    launch_serve.main(["--smoke", "--device", "cpu", "--n-requests", "3",
                       "--max-new-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("req 0: ")
    assert all(len(ast.literal_eval(ln.split("-> ")[1])) == 4 for ln in lines)
