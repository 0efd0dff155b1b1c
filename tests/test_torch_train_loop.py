"""The self-trainer's loop and CLI, and the TF32 switch every entry point
of the port goes through.

(a) `train` in both packages over ten steps (64×96, batch 1, a pool of two
    batches, every step logged) from the same JAX-initialised parameters,
    carried into the port by models/weights.py's reader of the flax file:
    every step's loss, EPE and pre-clip gradient norm, and the saved
    checkpoints. This covers `_run`, the pool's order, the cosine schedule
    at the real `steps`, the clip and AdamW. Step 0 (one set of parameters,
    one batch) is held to 1e-5 relative [1.1e-7, 0, 2.1e-6]. After it the
    float32 steps are chaotic: Adam's normalisation turns the last bits of
    a gradient element near zero into a step of up to ±lr, so the two
    packages drift apart by what float32 itself decides. The referee is
    the port's own drift: the same ten steps from the parameters scaled by
    1 + 1e-6·N(0, 1), two draws (the witnesses; one PyTorch thread, so
    that each run is reproducible). Each metric's largest gap to JAX over
    steps 1-9 is held to 3× the witnesses' largest gap [loss 1.86e-3
    against 5.26e-3, EPE 1.74e-3 against 5.66e-3, gnorm 9.8e-3 against
    1.60e-2], and each parameter tensor of the saved checkpoints to 3× the
    witnesses' largest gap in that tensor [at most 1.80×] or to a
    hundredth of one Adam step (0.01·lr), whichever is larger: a tensor
    whose gradient stays near zero (the delta head's bias moves by ~1e-7)
    differs from JAX by a few ulps (8e-4·lr), and a witness can move it by
    less (7e-5·lr in a two-thread run);
(b) `--stage flow` then `--stage dba` sharing `--out` writes the same bytes
    as `--stage both` (on one thread: see one_torch_thread);
(c) `full_float32` switches both TF32 flags off for a CUDA device and
    leaves them alone for the CPU; every CLI of the port reaches it through
    `resolve_device` (CUDA mocked available where resolve_device asks).
"""

import os

import numpy as np
import pytest
import torch

from splatslam_tpu_torch import full_float32, resolve_device
from splatslam_tpu_torch.models import weights as tweights
from splatslam_tpu_torch.train import droid_trainer as T
from test_torch_threads import few_torch_threads  # noqa: F401

STEPS, H, W, LR = 10, 64, 96, 2e-4
WITNESS = 1e-6


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test, put back after it."""
    before = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = before


@pytest.fixture
def one_torch_thread():
    """Bit-equal files need one summation order: under two threads the DBA
    step's gradients of the biases ahead of fnet's InstanceNorms (zero
    analytically, float noise in practice) change from run to run, and
    Adam turns that noise into steps of up to the learning rate."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# (a) ten steps of the flow stage against the JAX trainer
# ---------------------------------------------------------------------------

def _port_train(init, ckpt, perturb=0.0, seed=1):
    """The port's `train` from the flax file `init` (optionally each
    parameter scaled by 1 + perturb * N(0, 1), drawn from `seed`):
    (per-step records, the trained net)."""
    model = tweights.load_selftrained(init, device="cpu")
    if perturb:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.0 + perturb * torch.randn(p.shape, generator=g))
    rec = {}
    model, hist = T.train(steps=STEPS, batch=1, H=H, W=W, lr=LR, pool=2,
                          log_every=1, params=model, ckpt_path=ckpt,
                          device="cpu", records=rec)
    assert [r["epe"] for r in rec["steps"]] == hist
    return rec["steps"], model


def test_train_loop_matches_jax(tmp_path, monkeypatch, one_torch_thread):
    import jax
    from flax import serialization
    from splatslam_tpu.models.weights import init_params as jinit
    from splatslam_tpu.train import droid_trainer as J

    P0 = jax.tree_util.tree_map(np.array, jinit(jax.random.PRNGKey(0)))
    init = str(tmp_path / "init.msgpack")
    with open(init, "wb") as f:
        f.write(serialization.to_bytes(P0))

    # the JAX step's metrics at full precision (its log line rounds them)
    jax_steps = []
    make = J.make_train_step

    def recording(tx, iters=4):
        step = make(tx, iters=iters)

        def run(*a):
            out = step(*a)
            jax_steps.append({k: float(v) for k, v in out[2].items()})
            return out
        return run

    monkeypatch.setattr(J, "make_train_step", recording)
    jax_ckpt = str(tmp_path / "jax.msgpack")
    _, jax_hist = J.train(steps=STEPS, batch=1, H=H, W=W, lr=LR, pool=2,
                          log_every=1, params=P0, ckpt_path=jax_ckpt)
    assert [r["epe"] for r in jax_steps] == jax_hist

    port_ckpt = str(tmp_path / "port.msgpack")
    steps, model = _port_train(init, port_ckpt)
    witnesses = [_port_train(init, None, perturb=WITNESS, seed=seed)
                 for seed in (1, 2)]
    assert len(jax_steps) == len(steps) == STEPS
    assert all(tuple(r["shape"]) == (H, W) for r in steps)
    rel = lambda a, b, k: abs(a[k] - b[k]) / abs(b[k])
    gaps = {}
    for k in ("loss", "epe", "gnorm"):
        # step 0: the same parameters on the same batch
        assert rel(steps[0], jax_steps[0], k) <= 1e-5, k
        gap = max(rel(a, b, k) for a, b in zip(steps[1:], jax_steps[1:]))
        wit = max(rel(b, a, k) for w, _ in witnesses
                  for a, b in zip(steps[1:], w[1:]))
        gaps[k] = (gap, wit)
        assert gap <= 3 * wit, (k, gap, wit)
    # the loop learned: the last steps' EPE below the first ones'
    epe = [r["epe"] for r in steps]
    assert np.mean(epe[-2:]) < np.mean(epe[:2]), epe

    saved = tweights.load_selftrained(port_ckpt, device="cpu")
    ref = dict(tweights.load_selftrained(jax_ckpt, device="cpu")
               .named_parameters())
    wits = [dict(w.named_parameters()) for _, w in witnesses]
    for (n, a), b in zip(model.state_dict().items(),
                         saved.state_dict().values()):
        assert torch.equal(a, b), n         # what was trained was saved
    worst = (0.0, "")
    for n, p in saved.named_parameters():
        p = p.detach()
        gap = float((p - ref[n].detach()).abs().max())
        floor = max(float((p - w[n].detach()).abs().max()) for w in wits)
        assert gap <= max(3 * floor, 1e-2 * LR), (n, gap / LR, floor / LR)
        if gap > 1e-2 * LR:
            worst = max(worst, (gap / floor, n))
    print(f"train loop against JAX, {STEPS} steps: largest relative gap "
          f"over steps 1-{STEPS - 1} (JAX, witness) {gaps}; parameters: "
          f"largest gap {worst[0]:.2f}x the witness's ({worst[1]})")


# ---------------------------------------------------------------------------
# (b) the two-call split of the CLI against --stage both
# ---------------------------------------------------------------------------

def test_two_stage_calls_write_what_both_writes(tmp_path, one_torch_thread):
    from splatslam_tpu_torch import train_droid
    size = ["--steps", "2", "--batch", "1", "--dba-steps", "1",
            "--dba-batch", "1", "--pool", "1", "--buckets", "small",
            "--device", "cpu"]
    split, both = tmp_path / "split", tmp_path / "both"
    flow, dba = str(split / "flow.msgpack"), str(split / "dba.msgpack")
    assert train_droid.main(["--stage", "flow", "--out", flow] + size) == 0
    assert not os.path.exists(dba)
    assert train_droid.main(["--stage", "dba", "--out", flow, "--dba-out",
                             dba] + size) == 0
    assert train_droid.main(["--stage", "both", "--out",
                             str(both / "flow.msgpack"), "--dba-out",
                             str(both / "dba.msgpack")] + size) == 0
    for name in ("flow.msgpack", "dba.msgpack"):
        assert (split / name).read_bytes() == (both / name).read_bytes(), \
            name
    # the dba stage really started from the flow file: a random start
    # (what train_dba falls back to without one) writes other bytes
    cold = str(tmp_path / "cold.msgpack")
    assert train_droid.main(["--stage", "dba", "--out",
                             str(tmp_path / "absent.msgpack"), "--dba-out",
                             cold] + size) == 0
    assert (split / "dba.msgpack").read_bytes() != open(cold, "rb").read()


# ---------------------------------------------------------------------------
# (c) the TF32 switch
# ---------------------------------------------------------------------------

def test_full_float32_switches_tf32_off_on_cuda_only(tf32_on):
    full_float32(torch.device("cpu"))
    full_float32("cpu")
    assert _flags() == (True, True)
    full_float32(torch.device("cuda"))
    assert _flags() == (False, False)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    full_float32(torch.device("cuda", 1))
    assert _flags() == (False, False)


def test_resolve_device_switches_tf32_off(tf32_on, monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert _flags() == (True, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert _flags() == (False, False)


def _smoke_yaml(tmp_path):
    path = tmp_path / "smoke.yaml"
    path.write_text(
        "inherit_from: " + os.path.abspath("configs/Synthetic/smoke.yaml")
        + "\ndata:\n  output: " + str(tmp_path / "out") + "\n")
    return str(path)


# each CLI of the port with arguments that reach its first use of the card
CLIS = {
    "run": ("splatslam_tpu_torch.run", lambda t: [_smoke_yaml(t)]),
    "train_droid": ("splatslam_tpu_torch.train_droid",
                    lambda t: ["--out", str(t / "f.msgpack"), "--dba-out",
                               str(t / "d.msgpack")]),
    "flow_probe": ("splatslam_tpu_torch.tools.flow_probe", lambda t: []),
    "admission_calib": ("splatslam_tpu_torch.tools.admission_calib",
                        lambda t: []),
    "ate_matrix": ("splatslam_tpu_torch.tools.ate_matrix",
                   lambda t: ["base"]),
    "kernel_bench": ("splatslam_tpu_torch.tools.kernel_bench", lambda t: []),
    "map_step_profile": ("splatslam_tpu_torch.tools.map_step_profile",
                         lambda t: ["--ssim"]),
    "tracking_profile": ("splatslam_tpu_torch.tools.tracking_profile",
                         lambda t: []),
}


@pytest.mark.parametrize("cli", list(CLIS))
def test_every_cli_switches_tf32_off(cli, tf32_on, tmp_path, monkeypatch):
    """The CLI at its default device (CUDA) with CUDA mocked available: it
    runs until its first use of the card, which fails on this CPU-only
    build; by then both TF32 flags must be off."""
    import importlib
    module, args = CLIS[cli]
    mod = importlib.import_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        mod.main(args(tmp_path))
    except (AssertionError, RuntimeError) as e:
        assert "CUDA" in str(e), e
    assert _flags() == (False, False)
