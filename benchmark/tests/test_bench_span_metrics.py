"""The per-layer metrics that read the program's spans and counters
(map_iter_ms, map_idle_pct, round_us_per_edge, frontend_idle_pct,
host_syncs_per_frame): each on a hand-built record, None where what it
divides by is 0 or absent, and one traced CPU run through the harness."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

NEW = ("map_iter_ms", "map_idle_pct", "round_us_per_edge",
       "frontend_idle_pct", "host_syncs_per_frame")


def _rec(seconds=None, calls=None, idle=None, frames=10, traced=True):
    seconds = {"mapping": 4.0, "map.opt": 3.0, "frontend": 1.5,
               "online_ba": 0.5, "fe.round": 0.8, "n.edges": 400,
               "n.sync": 25} if seconds is None else seconds
    calls = {"map.iter": 120, "fe.round": 16, "n.edges": 16,
             "n.sync": 25} if calls is None else calls
    idle = {"mapping": 0.1, "map.opt": 0.5, "map.fwd": 1.0, "map.adam": 0.4,
            "mono": 7.0, "frontend": 0.2, "fe.rounds": 0.3, "fe.dba": 0.25,
            "lc.edges": 0.05, "online_ba": 0.2, "motion_filter": 9.0,
            "(between phases)": 3.0} if idle is None else idle
    trace = dict(busy_s=1.0, kernels=10, ops={}, idle_by_host=idle,
                 launches={}) if traced else None
    return dict(part=dict(window_s=20.0, frames=frames,
                          timers=dict(seconds=seconds, calls=calls,
                                      mapped=3, keyframes=4)),
                trace=trace)


def test_readings_of_a_hand_built_record():
    rec = _rec()
    read = lambda name: harness.read_metric(name, rec)
    assert read("map_iter_ms") == pytest.approx(1e3 * 3.0 / 120)
    # mapping and map.*: 0.1 + 0.5 + 1.0 + 0.4 over 4 s; not `mono`
    assert read("map_idle_pct") == pytest.approx(100.0 * 2.0 / 4.0)
    assert read("round_us_per_edge") == pytest.approx(1e6 * 0.8 / 400)
    # frontend, online_ba, fe.* and lc.*: 0.2 + 0.3 + 0.25 + 0.05 + 0.2
    # over 1.5 + 0.5 s
    assert read("frontend_idle_pct") == pytest.approx(100.0 * 1.0 / 2.0)
    assert read("host_syncs_per_frame") == pytest.approx(2.5)


@pytest.mark.parametrize("name,rec", [
    ("map_iter_ms", _rec(calls={})),
    ("map_iter_ms", _rec(calls={"map.iter": 0})),
    ("map_idle_pct", _rec(seconds={})),
    ("map_idle_pct", _rec(seconds={"mapping": 0.0})),
    ("map_idle_pct", _rec(traced=False)),
    ("round_us_per_edge", _rec(seconds={"fe.round": 1.0})),
    ("round_us_per_edge", _rec(seconds={"fe.round": 1.0, "n.edges": 0})),
    ("frontend_idle_pct", _rec(seconds={})),
    ("frontend_idle_pct", _rec(seconds={"frontend": 0.0,
                                        "online_ba": 0.0})),
    ("frontend_idle_pct", _rec(traced=False)),
    ("host_syncs_per_frame", _rec(frames=0)),
    ("host_syncs_per_frame", _rec(seconds={"mapping": 1.0})),
])
def test_none_where_the_divisor_is_zero_or_absent(name, rec):
    assert harness.read_metric(name, rec) is None


def test_no_idle_reads_zero_not_none():
    rec = _rec(idle={"motion_filter": 1.0})
    assert harness.read_metric("map_idle_pct", rec) == 0.0
    assert harness.read_metric("frontend_idle_pct", rec) == 0.0


def test_a_traced_cpu_run_reports_the_span_metrics():
    """The tiny replica_scale cell traced on the CPU: the spans and the
    edge counter are read; the CPU has no device trace, so the idle
    metrics read nothing, and it counts no synchronisations."""
    r = harness.run("replica_scale.orbit", 7, 3.0, True, "cpu",
                    overrides=tiny.shrink)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["map_iter_ms"] > 0 and m["round_us_per_edge"] > 0, m
    assert not {"map_idle_pct", "frontend_idle_pct",
                "host_syncs_per_frame"} & set(m), m
    assert r["correct"]
