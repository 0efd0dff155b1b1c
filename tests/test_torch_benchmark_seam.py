"""The seam between the program and its benchmark (benchmark/, the driver
of BENCHMARK.json), held on the CPU.

The benchmark wraps program entries by name: its FLOP terms and launch
records (probes.Counters.install) and its checked stages (stages/*.py,
`arm`) each `Patches.put` a wrapper on a module attribute or a method that
the program looks up at call time. A renamed entry, a changed signature or
a call that bypasses the lookup (a function imported by name) shows on the
card only as a failed run, a missing capture or a silent zero count. The
entries are discovered from the benchmark's own code with a recording
stand-in for `Patches`, so an entry the benchmark starts to wrap is
checked here without an edit:

  * test_wrapped_entry: each entry exists and is callable, each of the
    benchmark's wrappers builds around it, and the entry's signature takes
    the parameters the wrapper names (positional names in order, defaults
    the wrapper restates, keywords it reads from `**kw`, positions it reads
    from `*a`);
  * test_benchmark_reaches_its_entries: one tiny CPU run of each
    configuration that runs without the DPT (tiny.shrink, the benchmark
    tests' size), with a pass-through counting wrapper on every entry:
    the run calls each entry its configuration reaches through its
    wrapper, and the two runs together reach every entry but the DPT's;
  * test_an_exception_from_on_frame_ends_the_run: the harness ends
    `SLAM.run` by raising from `on_frame` (benchmark/harness.py,
    Window.__call__). The same runs end so, one frame at a time (oracle)
    and inside an admission chunk (learned): the exception leaves `run`
    unchanged, `terminate()` never runs, the threads the run started have
    ended within a second, and a second SLAM in the process then runs the
    stream as far as the first one went, to its end.

The benchmark is imported and never edited: its `Patches` installs the
counting wrappers, its `load_cell`, `slam_config`, `scene` and
`tiny.shrink` build the runs.
"""

import ast
import collections
import inspect
import json
import os
import textwrap
import threading
import time

import pytest

from benchmark import harness, probes, scene, stages
from benchmark.tests import tiny
from test_torch_threads import few_torch_threads  # noqa: F401

# entries no CPU run of the two configurations reaches, with the test that
# runs them instead
ELSEWHERE = {
    "models.dpt.DPTDepthModel.forward":
        "needs the `dpt` prior provider; tests/test_torch_prior.py runs it",
}
# entries one configuration does not reach (the other one does)
NOT_REACHED = {
    "synthetic_learned": {
        "tracking.factor_graph.FactorGraph._oracle_targets":
            "GT-flow targets: oracle tracking only",
    },
    "replica_scale": {
        "tracking.motion_filter.admission_scan":
            "the chunked admission: learned tracking only",
        "tracking.factor_graph.update_operator":
            "the learned update rounds: oracle targets replace them",
    },
}
# the stream of a run: past frame ~45 (learned) and ~17 (oracle), where
# each reaches its last entry, and within the tiny buffer's 48 keyframes
N_FRAMES = 64
SEED = 7


def _entry_id(owner, attribute):
    module = owner.__name__ if inspect.ismodule(owner) else owner.__module__
    path = module.removeprefix("splatslam_tpu_torch.")
    if not inspect.ismodule(owner):
        path += "." + owner.__qualname__
    return f"{path}.{attribute}"


class _Recorder:
    """Stands in for probes.Patches: records each put, wraps nothing."""

    def __init__(self):
        self.puts = []

    def put(self, owner, name, make):
        self.puts.append((owner, name, make))


def _discover():
    """{entry id: (owner, attribute, [the benchmark's wrapper makers])} of
    every entry the benchmark wraps: the counters' (FLOP terms, launch
    records) and every stage's."""
    rec = _Recorder()
    probes.Counters(96, 128, 32).install(rec)
    for mod in stages.modules().values():
        mod.arm(None, rec)
    out = {}
    for owner, name, make in rec.puts:
        out.setdefault(_entry_id(owner, name), (owner, name, []))[2].append(
            make)
    return out


ENTRIES = _discover()


def _configs():
    """{configuration name: the first cell that runs it}."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = {}
    for w in bench["workloads"]:
        out.setdefault(w["config"], w["name"])
    return out


CELLS = _configs()


def _read_names(wrapper):
    """What the wrapper reads of its variadic parameters: (keys of its
    `**kw` as string constants, including a comprehension over a tuple of
    them; indices of its `*a` as integer constants)."""
    sig = inspect.signature(wrapper)
    var = {p.kind: p.name for p in sig.parameters.values()}
    kw_name = var.get(inspect.Parameter.VAR_KEYWORD)
    a_name = var.get(inspect.Parameter.VAR_POSITIONAL)
    tree = ast.parse(textwrap.dedent(inspect.getsource(wrapper)))
    loops = {}              # comprehension variable -> the tuple it walks
    for node in ast.walk(tree):
        if isinstance(node, ast.comprehension) and isinstance(
                node.target, ast.Name) and isinstance(node.iter, ast.Tuple):
            loops[node.target.id] = [e.value for e in node.iter.elts]
    keys, indices = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(node.value,
                                                          ast.Name):
            s = node.slice
            if node.value.id == kw_name:
                if isinstance(s, ast.Constant):
                    keys.add(s.value)
                elif isinstance(s, ast.Name):
                    keys.update(loops.get(s.id, ()))
            elif node.value.id == a_name and isinstance(s, ast.Constant):
                indices.add(s.value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == kw_name
              and isinstance(node.args[0], ast.Constant)):
            keys.add(node.args[0].value)
    return keys, indices


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_wrapped_entry(entry):
    owner, name, makes = ENTRIES[entry]
    assert hasattr(owner, name), f"the benchmark wraps {entry}, which is gone"
    orig = getattr(owner, name)
    assert callable(orig), entry
    params = inspect.signature(orig).parameters
    positional = [p for p in params.values() if p.kind in (
        p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    star = any(p.kind == p.VAR_POSITIONAL for p in params.values())
    method = not inspect.ismodule(owner)
    for make in makes:
        wrapper = make(orig)
        assert callable(wrapper), entry
        named = [p for p in inspect.signature(wrapper).parameters.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        assert len(named) <= len(positional) or star, (
            entry, [p.name for p in named])
        for k, p in enumerate(named[:len(positional)]):
            if not (method and k == 0):     # `self` under another name
                # a trailing underscore spells a name the closure shadows
                assert positional[k].name == p.name.rstrip("_"), (
                    entry, k, p.name, positional[k].name)
            if p.default is not p.empty:
                # the wrapper hands its default on in the entry's place
                assert positional[k].default == p.default, (entry, p.name)
        keys, indices = _read_names(wrapper)
        assert keys <= set(params), (entry, keys - set(params))
        for i in indices:
            assert len(named) + i < len(positional) or star, (entry, i)


def _counting(calls, entry):
    def make(orig):
        def f(*a, **kw):
            calls[entry] += 1
            return orig(*a, **kw)
        return f
    return make


class _Stop(Exception):
    """Raised from the hook, as the harness raises its own."""


def _build(config, out_dir, n_frames):
    """A tiny SLAM of `config` (tiny.shrink) over the first n_frames of
    its cell's stream."""
    from splatslam_tpu_torch.slam import SLAM
    spec = harness.load_cell(CELLS[config])
    cfg = harness.slam_config(spec, str(out_dir))
    tiny.shrink(cfg, spec)
    tr = spec["traffic"]
    images, depths, c2w = scene.render_frames(
        cfg, SEED, n_frames, tr["motion_scale"], tr.get("loop_period", 0))
    return SLAM(cfg, device="cpu",
                stream=scene.Stream(cfg, images, depths, c2w))


def _stopped_run(config, out_dir):
    """One run with a counting wrapper on every entry, ended from the hook
    at the first frame after the configuration's entries were all called
    that is not the last of its admission chunk (any frame when frames go
    one at a time). Stops at the stream's end otherwise."""
    expected = set(ENTRIES) - set(ELSEWHERE) - set(NOT_REACHED[config])
    calls = collections.Counter()
    slam = _build(config, out_dir, N_FRAMES)
    # recorded, not run: the hook's stop must skip it, and a run that
    # reaches its stream's end need not pay the final BA and refine
    terminated = []
    slam.terminate = lambda: terminated.append(True)
    chunks, left = [], [0]      # the chunks' sizes; frames left in this one
    decide = slam.motion_filter.decide_batch

    def counted_decide(images_u8, n):
        chunks.append(n)
        left[0] = n
        return decide(images_u8, n)
    slam.motion_filter.decide_batch = counted_decide
    stop = _Stop()
    seen = []

    def hook(i, timestamp, kf_idx):
        seen.append((i, kf_idx))
        left[0] = max(left[0] - 1, 0)
        if expected <= set(calls) and (not chunks or left[0] > 0):
            raise stop

    patches = probes.Patches()
    before = set(threading.enumerate())
    raised = None
    try:
        for entry, (owner, name, _) in ENTRIES.items():
            if hasattr(owner, name):        # a missing one fails above
                patches.put(owner, name, _counting(calls, entry))
        slam.run(on_frame=hook)
    except _Stop as e:
        raised = e
    finally:
        patches.remove()
    started = [t for t in threading.enumerate() if t not in before]
    t0 = time.perf_counter()
    for t in started:
        t.join(timeout=max(1.0 - (time.perf_counter() - t0), 0.0))
    return dict(expected=expected, calls=calls, same=raised is stop,
                raised=raised, terminated=len(terminated), seen=seen,
                chunks=chunks, inside_chunk=left[0] > 0,
                alive=[t.name for t in started if t.is_alive()])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, few_torch_threads):
    """The stopped run of each configuration, made on first use."""
    done = {}

    def get(config):
        if config not in done:
            done[config] = _stopped_run(
                config, tmp_path_factory.mktemp(config))
        return done[config]
    return get


@pytest.mark.parametrize("config", ["synthetic_learned", "replica_scale"])
def test_benchmark_reaches_its_entries(config, runs):
    ids = set(ENTRIES)
    named = set(ELSEWHERE).union(*map(set, NOT_REACHED.values()))
    assert named <= ids, f"no longer wrapped: {named - ids}"
    # no entry is left to no run
    assert not set(NOT_REACHED["synthetic_learned"]) & set(
        NOT_REACHED["replica_scale"])
    r = runs(config)
    missing = sorted(r["expected"] - set(r["calls"]))
    assert not missing, (f"{config}: never called through the benchmark's "
                         f"lookup: {missing}")


@pytest.mark.parametrize("loop,config", [("per_frame", "replica_scale"),
                                         ("chunked", "synthetic_learned")])
def test_an_exception_from_on_frame_ends_the_run(loop, config, runs,
                                                 tmp_path):
    r = runs(config)
    assert r["same"], f"run ended with {r['raised']!r}, not the hook's"
    assert r["terminated"] == 0
    assert not r["alive"], f"threads still running: {r['alive']}"
    i, kf_idx = r["seen"][-1]
    assert i < N_FRAMES - 1 and kf_idx >= 1
    if loop == "chunked":
        assert max(r["chunks"]) > 1 and r["inside_chunk"], r["chunks"]
    else:
        assert r["chunks"] == []
    # a second run in the same process, over the stream as far as the
    # first one went, goes to its end
    n = i + 1
    slam = _build(config, tmp_path, n)
    done = object()
    terminated = []             # reached once, after the last frame
    slam.terminate = lambda: terminated.append(True) or done
    seen = []
    assert slam.run(on_frame=lambda i, t, k: seen.append(i)) is done
    assert seen == list(range(n)) and terminated == [True]
    assert slam.mapper.initialized
