"""The DBA step batched over scenes, and the start of a continued recipe.

  (a) make_dba_train_step on B = 2 scenes (one forward over the batch, one
      backward) against the JAX trainer's step, which vmaps scene_loss
      over the batch and takes the mean: loss, ATE, gnorm and every
      gradient tensor at the tolerances of test_torch_train.py's DBA step
      (its docstring gives the measured gaps and why);
  (b) `dba` with a leading scene dimension against `dba` run scene by
      scene: poses and disparities within 2e-5 (float32: the batched
      matmuls sum in another order), each scene's gauge pose unchanged
      bit for bit, a failed solve zeroing only its own scene's step;
  (c) the shipped pretrained/droid_dba.msgpack through the port's DBA loss
      and through the JAX scene_loss on one seeded batch: loss and ATE
      within 1e-4 relative (the CPU side of chip_smoke.py --dba-eval);
  (d) `train_droid --stage flow --init X` starts from exactly the
      parameters the JAX package's load_selftrained(X) gives.
"""

import numpy as np
import jax
import optax
import pytest
import torch

from splatslam_tpu.models.weights import init_params as jinit
from splatslam_tpu.train import droid_trainer as J
from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import weights as tweights
from splatslam_tpu_torch.ops import ba as tba, lie as tlie
from splatslam_tpu_torch.train import droid_trainer as T
from test_torch_threads import few_torch_threads  # noqa: F401
from test_torch_train import (DBA_TOL, N_SEQ, H, W, _check_grads, _grads,
                              _np, _port_net, _rel, _sgd_grads)

SHIPPED_DBA = "pretrained/droid_dba.msgpack"
SHIPPED_FLOW = "pretrained/droid_selftrained.msgpack"
B = 2


@pytest.fixture(scope="module")
def jax_side():
    """One compiled JAX DBA step (B = 2, N = 5, 64×96, 2 rounds), run from
    the seeded parameters and from the shipped checkpoint's."""
    step = J.make_dba_train_step(optax.sgd(1.0), N=N_SEQ, iters=2)
    seq = J.make_seq_batch(np.random.RandomState(3), B, N_SEQ, H, W)
    P0 = _np(jinit(jax.random.PRNGKey(0)))
    shipped = _np(J.load_selftrained(SHIPPED_DBA))
    return dict(P0=P0, seq=[np.array(x) for x in seq],
                dba=_sgd_grads(step, P0, seq),
                shipped=_sgd_grads(step, shipped, seq)[1])


def test_batched_dba_step_matches_jax_vmap(jax_side):
    """(a): B = 2 through the port's one-pass step against the JAX step's
    vmap and mean."""
    g_j, m_j = jax_side["dba"]
    model = _port_net(jax_side["P0"])
    opt = T.make_optimizer(model, 0.0, 10)
    step = T.make_dba_train_step(model, opt, N=N_SEQ, iters=2)
    m = step(*[torch.as_tensor(x) for x in jax_side["seq"]])
    # the step clipped the gradients by 1/gnorm in place: undo it
    scale = float(m["gnorm"])
    assert scale >= 1.0
    got = {n: g * scale for n, g in _grads(model).items()}
    assert _rel(float(m["loss"]), m_j["loss"]) <= 1e-4
    assert _rel(float(m["ate"]), m_j["ate"]) <= 1e-4
    assert _rel(float(m["gnorm"]), m_j["gnorm"]) <= 1e-3
    worst = _check_grads(got, g_j, lambda n: DBA_TOL,
                         floor_names=("update.flow_encoder.0.bias",
                                      "update.flow_encoder.2.bias"))
    for n in ("update.weight.2.weight", "update.agg.eta.0.weight"):
        assert float(got[n].abs().max()) > 0
        assert float((got[n] - g_j[n]).abs().max()) \
            <= DBA_TOL * float(g_j[n].abs().max()), n
    print(f"batched dba step: loss {float(m['loss'])} vs {m_j['loss']}, ate "
          f"{float(m['ate'])} vs {m_j['ate']}, gnorm {float(m['gnorm'])} vs "
          f"{m_j['gnorm']}, worst gradient gap {worst:.2e}")


def test_batch_loss_is_the_scenes_losses(jax_side):
    """dba_batch_loss on two scenes gives each scene's dba_scene_loss, and
    the mean of the losses back-propagates to the mean of the scenes'
    gradients (what the per-scene loop summed)."""
    model = _port_net(jax_side["P0"])
    seq = [torch.as_tensor(x) for x in jax_side["seq"]]
    losses, ates = T.dba_batch_loss(model, *seq, N=N_SEQ, iters=2)
    losses.mean().backward()
    batched = {n: g.clone() for n, g in _grads(model).items()}
    model.zero_grad(set_to_none=True)
    for b in range(B):
        loss, ate = T.dba_scene_loss(model, *[x[b] for x in seq], N=N_SEQ,
                                     iters=2)
        (loss / B).backward()
        assert _rel(float(losses[b]), float(loss)) <= 1e-5
        assert _rel(float(ates[b]), float(ate)) <= 1e-5
    _check_grads(batched, _grads(model), lambda n: DBA_TOL,
                 floor_names=("update.flow_encoder.0.bias",
                              "update.flow_encoder.2.bias"))


def _scenes(S=3, N=6, h=8, w=10, seed=0):
    g = torch.Generator().manual_seed(seed)
    ii, jj = T.seq_edges(N)
    E = len(ii)
    poses = torch.cat([0.1 * torch.randn(S, N, 3, generator=g),
                       torch.zeros(S, N, 3), torch.ones(S, N, 1)], -1)
    poses = tlie.normalize(tlie.retr(poses, 0.05 * torch.randn(
        S, N, 6, generator=g)))
    disps = 0.5 + torch.rand(S, N, h, w, generator=g)
    intr = torch.stack([torch.tensor([f, f, w / 2 - 0.5, h / 2 - 0.5])
                        for f in (8.0, 11.0, 14.0)[:S]])
    target = torch.rand(S, E, h, w, 2, generator=g) * torch.tensor([w, h])
    weight = torch.rand(S, E, h, w, 2, generator=g)
    edges = tba.make_edges(ii, jj, 1, N)
    eta = 1e-3 + 1e-2 * torch.rand(S, edges.M, h, w, generator=g)
    sens = (torch.rand(S, N, h, w, generator=g) > 0.5) * disps
    return poses, disps, intr, target, weight, eta, sens, edges


@pytest.mark.parametrize("motion_only", [False, True])
def test_batched_dba_matches_per_scene(motion_only):
    """(b): S = 3 scenes (each with its own intrinsics and sensor prior) in
    one call against dba on each scene; the gauge frame of every scene
    stays where it was."""
    poses, disps, intr, target, weight, eta, sens, edges = _scenes()
    got = tba.dba(poses, disps, intr, target, weight, eta, sens, edges,
                  iters=3, motion_only=motion_only)
    for s in range(poses.shape[0]):
        want = tba.dba(poses[s], disps[s], intr[s], target[s], weight[s],
                       eta[s], sens[s], edges, iters=3,
                       motion_only=motion_only)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[s].numpy(), b.numpy(), rtol=0,
                                       atol=2e-5)
        assert torch.equal(got[0][s, 0], poses[s, 0])
        assert float((got[0][s, 1:] - poses[s, 1:]).abs().max()) > 1e-3


def test_batched_dba_falls_back_per_scene():
    """A scene whose system is not finite gets a zero step while the others
    solve as on their own: jax.vmap of dba, where each scene's solve falls
    back on its own (the batch-wide fallback would freeze every scene)."""
    poses, disps, intr, target, weight, eta, sens, edges = _scenes()
    weight = weight.clone()
    weight[1, 0, 0, 0, 0] = float("nan")
    got = tba.dba(poses, disps, intr, target, weight, eta, sens, edges,
                  iters=1, motion_only=True)[0]
    np.testing.assert_allclose(got[1].numpy(), poses[1].numpy(), rtol=0,
                               atol=1e-6)
    for s in range(3):
        want = tba.dba(poses[s], disps[s], intr[s], target[s], weight[s],
                       eta[s], sens[s], edges, iters=1, motion_only=True)[0]
        np.testing.assert_allclose(got[s].numpy(), want.numpy(), rtol=0,
                                   atol=2e-5)
        if s != 1:
            assert float((got[s, 1:] - poses[s, 1:]).abs().max()) > 1e-3


def test_shipped_checkpoint_loss_matches_jax(jax_side):
    """(c): the shipped DBA checkpoint, no update, through the port's
    batched loss and the JAX trainer's scene_loss (vmapped, mean)."""
    m_j = jax_side["shipped"]
    model = tweights.load_selftrained(SHIPPED_DBA, device="cpu")
    with torch.no_grad():
        losses, ates = T.dba_batch_loss(
            model, *[torch.as_tensor(x) for x in jax_side["seq"]], N=N_SEQ,
            iters=2)
    loss, ate = float(losses.mean()), float(ates.mean())
    print(f"shipped checkpoint: loss {loss} vs {m_j['loss']}, ate {ate} vs "
          f"{m_j['ate']}")
    assert _rel(loss, m_j["loss"]) <= 1e-4
    assert _rel(ate, m_j["ate"]) <= 1e-4


def test_flow_stage_init_is_jax_load_selftrained(tmp_path, monkeypatch):
    """(d): `--stage flow --init X` hands train() exactly the parameters of
    the JAX load_selftrained(X); one step at lr 0 writes them back
    unchanged."""
    from splatslam_tpu_torch import train_droid
    seen = {}
    real = T.train

    def spy(**kw):
        seen.update({n: p.detach().clone()
                     for n, p in kw["params"].state_dict().items()})
        return real(**kw)

    monkeypatch.setattr(T, "train", spy)
    out = str(tmp_path / "flow.msgpack")
    assert train_droid.main([
        "--stage", "flow", "--init", SHIPPED_FLOW, "--steps", "1", "--lr",
        "0", "--batch", "1", "--pool", "1", "--buckets", "small", "--out",
        out, "--device", "cpu"]) == 0
    want = convert.droid_params_from_numpy(_np(J.load_selftrained(
        SHIPPED_FLOW)))
    assert seen.keys() == want.keys()
    back = tweights.load_selftrained(out, device="cpu").state_dict()
    for n, t in want.items():
        assert torch.equal(seen[n], t), n
        assert torch.equal(back[n], t), n


@pytest.mark.slow
def test_shipped_checkpoint_full_width_matches_jax():
    """(c) at the trainer's protocol (`-m slow`, ~3 min): one seeded batch
    of 2 sequences at 240×320 (fx 200), N = 7, 8 rounds, the shipped DBA
    checkpoint with no update, through the JAX trainer's step and the
    port's batched loss. Both read an ATE of ~0.086 on these fresh
    sequences (the JAX trainer logged 0.005-0.007 over its own training
    batches). Held to 1e-3 relative: eight float32 rounds of the solver
    move the port's own loss by 2.3e-4 between 2 and 4 CPU threads
    (against JAX: 2.3e-4 and 1.6e-5 for the loss, 1.7e-4 at 4 threads for
    the ATE)."""
    Hb, Wb, fx = T.FLOW_BUCKETS[-1]
    seq = T.make_seq_batch(np.random.RandomState(0), B, 7, Hb, Wb, fx)
    P = J.load_selftrained(SHIPPED_DBA)
    tx = optax.sgd(0.0)
    _, _, m = J.make_dba_train_step(tx, N=7, iters=8)(
        P, tx.init(P), *[jax.numpy.asarray(x.numpy()) for x in seq])
    model = tweights.load_selftrained(SHIPPED_DBA, device="cpu")
    with torch.no_grad():
        losses, ates = T.dba_batch_loss(model, *seq, N=7, iters=8)
    loss, ate = float(losses.mean()), float(ates.mean())
    print(f"shipped checkpoint at {Hb}x{Wb}: loss {loss} vs "
          f"{float(m['loss'])}, ate {ate} vs {float(m['ate'])}")
    assert _rel(loss, float(m["loss"])) <= 1e-3
    assert _rel(ate, float(m["ate"])) <= 1e-3
