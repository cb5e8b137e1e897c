"""Port vs JAX package: monitor.py's ``record`` / ``show`` / ``report``
and viz.py's text output, on the same recorded spans and the same numpy
inputs; ``torch_trace`` writes a Chrome trace.

The clocks and the rusage both packages read are pinned, so the two
tables must match character for character.  matplotlib is off in both
(it is not installed here; pinned off in case it is), so viz takes its
ASCII path.
"""

import json
import resource
import time

import numpy as np
import pytest
import torch

from vsim_tpu import monitor as jmon
from vsim_tpu import viz as jviz
from vsim_tpu_torch import monitor as tmon
from vsim_tpu_torch import viz as tviz


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "perf_counter", lambda: 100.0)
    monkeypatch.setattr(time, "process_time", lambda: 50.0)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    monkeypatch.setattr(resource, "getrusage", lambda who: ru)


def _fill(m):
    m.record("serve/admit", 0.125, calls=3)
    m.record("serve/step_chunk", 2.5, calls=40)
    m.record("device/k10", 0.0625, calls=112, depth=1)
    with m.span("outer"):
        with m.span("inner"):
            pass


def test_record_report_show_match_jax(pinned, capsys):
    j, t = jmon.Monitor(), tmon.Monitor()
    for m in (j, t):
        m._t_start = 90.0
        _fill(m)
    assert t.report() == j.report()
    assert t.report(total=4.0) == j.report(total=4.0)
    assert {k: (v.name, v.depth, v.wall_s, v.calls)
            for k, v in t.stats().items()} == {
        k: (v.name, v.depth, v.wall_s, v.calls)
        for k, v in j.stats().items()}
    j.show()
    want = capsys.readouterr().out
    t.show()
    assert capsys.readouterr().out == want


def test_module_level_record_and_show(pinned, capsys):
    tmon.reset()
    jmon.reset()
    for m in (jmon, tmon):
        m.record("x", 1.5, calls=2)
    jmon.show()
    want = capsys.readouterr().out
    tmon.show()
    assert capsys.readouterr().out == want
    tmon.reset()
    jmon.reset()


@pytest.fixture
def no_mpl(monkeypatch):
    monkeypatch.setattr(jviz, "_have_mpl", lambda: False)
    monkeypatch.setattr(tviz, "_have_mpl", lambda: False)


def _out(capsys, fn, *args, **kw):
    ret = fn(*args, **kw)
    return ret, capsys.readouterr().out


@pytest.mark.parametrize("shape", [(40, 100), (5, 7), (3, 4, 6)])
def test_heatmap_text_matches_jax(no_mpl, capsys, shape):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = _out(capsys, jviz.heatmap, a, title="act map")
    assert _out(capsys, tviz.heatmap, a, title="act map") == want
    assert _out(capsys, tviz.heatmap, torch.from_numpy(a),
                title="act map") == want
    assert want[1].startswith("-- act map")


def test_trace_and_top_tokens_match_jax(no_mpl, capsys):
    y = np.cumsum(np.random.default_rng(1).standard_normal(200))
    want = _out(capsys, jviz.trace, y, title="loss")
    assert _out(capsys, tviz.trace, y, title="loss") == want
    assert _out(capsys, tviz.trace, torch.from_numpy(y), title="loss") == want
    lg = np.random.default_rng(2).standard_normal(50).astype(np.float32)
    want = _out(capsys, jviz.top_tokens, lg, k=5)
    assert _out(capsys, tviz.top_tokens, lg, k=5) == want
    want = _out(capsys, jviz.top_tokens, lg, k=3, decode=lambda t: f"<{t[0]}>")
    assert _out(capsys, tviz.top_tokens, torch.from_numpy(lg), k=3,
                decode=lambda t: f"<{t[0]}>") == want
    # a bad input is a no-op, never an error
    assert _out(capsys, tviz.heatmap, "not an array") == \
        _out(capsys, jviz.heatmap, "not an array")


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with tmon.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(prof.key_averages()) > 0
