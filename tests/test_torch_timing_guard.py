"""The guard on every differenced time of the port (vsim_tpu_torch/timing.py:
``differenced``), under a stubbed clock.

bench.py's step, ``monitor.chain_time`` and tools/mini_tpu_bench.py each
time a long and a short loop and divide the difference by the difference of
their lengths.  A difference is resolved only when every long rep took
longer than every short rep; otherwise the pair is measured again with the
long loop doubled, and a difference that never resolves raises
``UnresolvedDifference`` with every rep's seconds.  Here the clock stands
still (``time.perf_counter`` patched to a constant), so the long loops take
no longer than the short ones: each site must re-measure, grow the long
loop, and raise; the entry points must exit non-zero and print no rate.
"""

import pytest
import torch

from vsim_tpu_torch import bench, monitor, timing
from vsim_tpu_torch.convert.store import save_params
from vsim_tpu_torch.engine.generate import engine_params
from vsim_tpu_torch.models.config import ModelConfig
from vsim_tpu_torch.models.init import init_params, random_q4_params
from vsim_tpu_torch.timing import (GROWS, UnresolvedDifference, differenced,
                                   resolved)
from vsim_tpu_torch.tools import mini_tpu_bench, serve_profile

NEOX = dict(arch="gptneox", n_vocab=256, n_ctx=128, n_embd=128, n_head=4,
            n_layer=2, n_ff=256, n_rot=16, activation="gelu_exact")
TINY_BENCH = ["--device", "cpu", "--model", "tiny-neox", "--batch", "2",
              "--tokens", "6", "--decode-chunk", "3", "--n-ctx", "32",
              "--prompt-len", "4"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def still_clock(monkeypatch):
    """``time.perf_counter`` returns one value: every timed run takes 0 s."""
    monkeypatch.setattr(timing.time, "perf_counter", lambda: 1000.0)


@pytest.fixture
def tiny_preset(monkeypatch):
    """A two-layer preset for the bench's command line."""
    monkeypatch.setitem(bench.PRESETS, "tiny-neox", ModelConfig(**NEOX))


def lengths(err: UnresolvedDifference):
    return [(ns, nl) for ns, nl, _, _ in err.tries]


def test_differenced_takes_a_resolved_pair_as_it_is():
    calls = []

    def run(n):
        calls.append(n)
        return [n * 1.0 + 0.1 * i for i in range(3)]

    d = differenced(run, 2, 10)
    assert calls == [2, 10] and d["tries"] == 1
    assert (d["n_short"], d["n_long"]) == (2, 10)
    assert resolved(d["short_s"], d["long_s"])


def test_differenced_grows_the_long_loop_until_it_resolves():
    """The first pair overlaps (a short rep as long as a long one); the
    second, with the long loop doubled, does not."""
    def run(n):
        return [5.0, 1.0] if n == 2 else [n * 0.5, n * 0.5 + 0.1]

    d = differenced(run, 2, 8)
    assert (d["n_long"], d["tries"]) == (16, 2)
    assert min(d["long_s"]) > max(d["short_s"])


def test_differenced_raises_with_every_rep_and_caps_the_growth():
    with pytest.raises(UnresolvedDifference) as e:
        differenced(lambda n: [1.0, 1.0], 3, 10, n_max=30, what="stub")
    assert lengths(e.value) == [(3, 10), (3, 20), (3, 30), (3, 30)]
    assert len(e.value.tries) == GROWS + 1
    assert all(s == [1.0, 1.0] and lg == [1.0, 1.0]
               for _, _, s, lg in e.value.tries)
    assert "stub" in str(e.value) and "no time is given" in str(e.value)
    with pytest.raises(ValueError):
        differenced(lambda n: [1.0], 4, 4)
    with pytest.raises(ValueError):
        differenced(lambda n: [1.0], 4, 40, n_max=30)


def test_chain_time_remeasures_then_raises(still_clock):
    steps = []

    def step(p, carry):
        steps.append(1)
        return (carry[0] + 1.0,)

    with pytest.raises(UnresolvedDifference) as e:
        monitor.chain_time(step, None, (torch.zeros(4),), reps=2,
                           n_short=2, n_long=10)
    assert lengths(e.value) == [(2, 10), (2, 20), (2, 40), (2, 80)]
    # each try: a warm chain and two timed reps of each length
    assert len(steps) == sum(3 * (ns + nl) for ns, nl in lengths(e.value))


def test_chain_time_grows_the_long_chain_only_to_n_max(still_clock):
    with pytest.raises(UnresolvedDifference) as e:
        monitor.chain_time(lambda p, c: c, None, (torch.zeros(1),), reps=2,
                           n_short=2, n_long=10, n_max=25)
    assert lengths(e.value) == [(2, 10), (2, 20), (2, 25), (2, 25)]


def test_serve_profile_keeps_its_chains_inside_the_cache(still_clock):
    """serve_profile's chain moves the cache position a row a step from
    N_PAST0, so its long chain grows no further than the cache holds."""
    cfg = ModelConfig(**NEOX, kv_dtype="int8")
    params = engine_params(cfg, random_q4_params(cfg, seed=0, device="cpu"),
                           torch.device("cpu"))
    n_ctx = 40
    with pytest.raises(UnresolvedDifference) as e:
        serve_profile.profile(cfg, params, 1, n_ctx, torch.device("cpu"),
                              reps=1)
    cap = n_ctx - serve_profile.N_PAST0
    assert lengths(e.value) == [(4, 20), (4, cap), (4, cap), (4, cap)]


def test_chain_time_differences_a_moving_clock(monkeypatch):
    """With a clock that moves, the chain's step is the differenced time."""
    t = [0.0]

    def step(p, carry):
        t[0] += 1e-3  # each step takes one "millisecond"
        return carry

    monkeypatch.setattr(timing.time, "perf_counter", lambda: t[0])
    got = monitor.chain_time(step, None, (torch.zeros(1),), reps=3)
    assert got == pytest.approx(1e-3)


def test_bench_steady_remeasures_then_raises(still_clock, tiny_preset):
    args = bench.parse_args(TINY_BENCH)
    _, engine, _ = bench.build(args)
    prompt = list(range(1, args.prompt_len + 1))
    with pytest.raises(UnresolvedDifference) as e:
        bench.steady(engine, prompt, 2, 3, 6, reps=2)
    # the long loop doubled up to the n_ctx the prompt leaves (32 - 4)
    assert lengths(e.value) == [(3, 6), (3, 12), (3, 24), (3, 28)]
    assert all(s == [0.0, 0.0] and lg == [0.0, 0.0]
               for _, _, s, lg in e.value.tries)


def test_bench_main_exits_nonzero_and_prints_no_rate(still_clock,
                                                     tiny_preset, capsys):
    assert bench.main(TINY_BENCH) == 1
    out, err = capsys.readouterr()
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    assert "UnresolvedDifference" not in out and "no time is given" in err


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    cfg = ModelConfig(**NEOX)
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt")
    save_params(path, cfg, init_params(cfg, seed=0, device="cpu"))
    return path


def test_mini_tpu_bench_measure_remeasures_then_raises(still_clock,
                                                       small_ckpt):
    with pytest.raises(UnresolvedDifference) as e:
        mini_tpu_bench.measure(small_ckpt, 40, torch.device("cpu"))
    n_max = NEOX["n_ctx"] - len(mini_tpu_bench.PROMPT)
    assert lengths(e.value) == [(32, 40), (32, 80), (32, n_max),
                                (32, n_max)]
    assert all(len(s) == 3 and len(lg) == 3 for _, _, s, lg in e.value.tries)


def test_mini_tpu_bench_main_exits_nonzero_and_writes_no_row(
        still_clock, small_ckpt, tmp_path, capsys):
    out = tmp_path / "out.json"
    assert mini_tpu_bench.main(["--ckpt", small_ckpt, "--tokens", "40",
                                "--out", str(out), "--reference",
                                str(tmp_path / "none.json"),
                                "--device", "cpu"]) == 1
    printed, err = capsys.readouterr()
    assert not out.exists()
    assert not [ln for ln in printed.splitlines() if ln.startswith("{")]
    assert "tokens_per_s" not in printed and "no time is given" in err
