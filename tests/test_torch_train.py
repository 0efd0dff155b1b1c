"""Self-trainer parity: the PyTorch port's train/droid_trainer.py against the
JAX package's, both float32 on the CPU, from the same seeded batches and
the same flax parameters (`init_params(PRNGKey(0))`, carried across by
convert.droid_params_from_numpy).

The JAX gradients come from the JAX package's own train steps run with
optax.sgd(1.0), so g = P0 − P1 (P0 is copied to numpy first: the steps
donate their inputs). The JAX side is computed once per module.

Tolerances, measured gaps in brackets (the port's float64 run is the
referee where float32 cannot agree better):
  * batches: images bit-identical; flows, disparities, poses within 1e-5
    [0: the renderers draw the same numbers and run the same float32 ops];
  * flow step (64×96, batch 2, 8 iterations): loss, EPE, pre-clip gnorm
    within 1e-4 relative [6e-8, 0, 1.8e-6]; each gradient tensor of cnet and
    the update operator within 1e-3 of its max |g| [≤ 5e-4], of fnet within
    1e-2 [7e-3: the JAX side's own float32 error there, 7e-3 from the
    port's float64 gradient, where the port's float32 is within 3e-6];
  * DBA step (N = 5, 64×96, 2 rounds): loss and ATE within 1e-4 relative
    [1.4e-5, 1.8e-5], gnorm within 1e-3 [3.7e-4; float32 through the Schur
    solve: the two packages are 4e-4 and 7e-4 from the port's float64
    value]; each gradient tensor within 1e-2 of its max |g| [≤ 3.4e-3, at
    the eta head's bias, where the port's float32 is 7.5e-3 and the JAX
    side's 4.2e-3 from the port's float64 value];
  * the biases ahead of an InstanceNorm (fnet) have a zero gradient
    analytically: both packages' are below 1e-6 of the largest gradient;
    the flow-encoder biases of the DBA step are a sum over every edge pixel
    that cancels to a few per cent of its terms, so float32 cannot resolve
    it in either package (the port's float32 is ~100% of the tensor's max
    from its float64 value): they are held to 2e-2 of the largest gradient;
  * optimizer: parameters within 1e-6 of optax's after each of 6 updates.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from splatslam_tpu.models.weights import init_params as jinit
from splatslam_tpu.ops import ba as jba
from splatslam_tpu.train import droid_trainer as J
from splatslam_tpu_torch import convert
from splatslam_tpu_torch.models import droid_net as tnet
from splatslam_tpu_torch.models import weights as tweights
from splatslam_tpu_torch.ops import ba as tba, lie as tlie
from splatslam_tpu_torch.train import droid_trainer as T
from test_torch_threads import few_torch_threads  # noqa: F401

N_SEQ, H, W = 5, 64, 96
FLOW_TOL = {"fnet": 1e-2, "cnet": 1e-3, "update": 1e-3}
DBA_TOL = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _sgd_grads(step, P0, batch):
    """Gradients and metrics of one JAX train step, through sgd(1.0)."""
    tx = optax.sgd(1.0)
    P1, _, m = step(jax.tree_util.tree_map(jnp.array, P0),
                    tx.init(jax.tree_util.tree_map(jnp.array, P0)), *batch)
    g = jax.tree_util.tree_map(lambda a, b: a - np.asarray(b), P0, P1)
    return (tweights.flax_tree_to_state_dict(g),
            {k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    P0 = _np(jinit(jax.random.PRNGKey(0)))
    pair = J.make_pair_batch(np.random.RandomState(0), 2, H, W)
    seq = J.make_seq_batch(np.random.RandomState(0), 1, N_SEQ, H, W)
    flow = _sgd_grads(J.make_train_step(optax.sgd(1.0), iters=8), P0, pair)
    dba = _sgd_grads(J.make_dba_train_step(optax.sgd(1.0), N=N_SEQ, iters=2),
                     P0, seq)
    ckpt = str(tmp_path_factory.mktemp("jax") / "droid.msgpack")
    trained, _ = J.train(steps=1, batch=1, H=H, W=W, iters=1, pool=1,
                         ckpt_path=ckpt, log_every=10)
    return dict(P0=P0, pair=[np.array(x) for x in pair],
                seq=[np.array(x) for x in seq], flow=flow, dba=dba,
                ckpt=ckpt, trained=_np(trained))


def _port_net(P0):
    model = tnet.DroidNet(device="cpu", trainable=True)
    model.load_state_dict(convert.droid_params_from_numpy(P0), strict=True)
    return model


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _check_grads(got, want, tol_of, floor_names=()):
    """Each tensor within tol_of(name) of its max |g|; the tensors whose
    gradient is zero analytically, or cancellation-limited, against the
    largest gradient of all (see the module docstring). Returns the worst
    relative gap of the tensors held to their own maximum."""
    gmax = max(float(g.abs().max()) for g in want.values())
    worst = 0.0
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        # every conv bias of fnet but the last feeds an InstanceNorm
        if n.startswith("fnet.") and n.endswith(".bias") \
                and n != "fnet.conv2.bias":
            assert float(w.abs().max()) <= 1e-6 * gmax, n
            assert float(got[n].abs().max()) <= 1e-6 * gmax, n
        elif n in floor_names:
            assert err <= 2e-2 * gmax, (n, err, gmax)
        elif float(w.abs().max()) == 0:         # a head the loss never uses
            assert float(got[n].abs().max()) == 0, n
        else:
            rel = err / float(w.abs().max())
            worst = max(worst, rel)
            assert rel <= tol_of(n), (n, rel)
    return worst


def test_batches_match_jax(jax_side):
    """One seed, the same pairs and sequences in both packages."""
    pair = T.make_pair_batch(np.random.RandomState(0), 2, H, W)
    seq = T.make_seq_batch(np.random.RandomState(0), 1, N_SEQ, H, W)
    for got, want in ((pair, jax_side["pair"]), (seq, jax_side["seq"])):
        assert np.array_equal(got[0].numpy(), want[0])      # images
        for g, w in zip(got[1:], want[1:]):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
    # the valid masks are exactly equal: no pixel sits on the depth test
    assert int((pair[3].numpy() != jax_side["pair"][3]).sum()) == 0


def test_flow_step_matches_jax(jax_side):
    g_j, m_j = jax_side["flow"]
    model = _port_net(jax_side["P0"])
    batch = [torch.as_tensor(x) for x in jax_side["pair"]]
    loss, epe = T.flow_loss(model, *batch, iters=8)
    loss.backward()
    loss, epe = loss.detach(), epe.detach()
    got = _grads(model)
    gnorm = float(torch.linalg.vector_norm(
        torch.cat([g.reshape(-1) for g in got.values()]),
        dtype=torch.float64))
    assert _rel(float(loss), m_j["loss"]) <= 1e-4
    assert _rel(float(epe), m_j["epe"]) <= 1e-4
    assert _rel(gnorm, m_j["gnorm"]) <= 1e-4
    worst = _check_grads(got, g_j, lambda n: FLOW_TOL[n.split(".")[0]])
    print(f"flow step: loss {float(loss)} vs {m_j['loss']}, epe "
          f"{float(epe)} vs {m_j['epe']}, gnorm {gnorm} vs {m_j['gnorm']}, "
          f"worst gradient gap {worst:.2e}")


def test_train_step_metrics_match_jax(jax_side):
    """make_train_step itself: its (loss, epe, gnorm) are those of the JAX
    step on the same batch and parameters."""
    _, m_j = jax_side["flow"]
    model = _port_net(jax_side["P0"])
    step = T.make_train_step(model, T.make_optimizer(model, 2e-4, 10),
                             iters=8)
    m = step(*[torch.as_tensor(x) for x in jax_side["pair"]])
    for k in ("loss", "epe", "gnorm"):
        assert _rel(float(m[k]), m_j[k]) <= 1e-4, k


def test_dba_step_matches_jax(jax_side):
    g_j, m_j = jax_side["dba"]
    model = _port_net(jax_side["P0"])
    opt = T.make_optimizer(model, 0.0, 10)
    step = T.make_dba_train_step(model, opt, N=N_SEQ, iters=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = step(*[torch.as_tensor(x) for x in jax_side["seq"]])
    # lr 0 with weight decay scaled by it: the step leaves the parameters
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    got = _grads(model)
    # the step clipped the gradients by 1/gnorm in place: undo it
    scale = float(m["gnorm"])
    assert scale >= 1.0
    got = {n: g * scale for n, g in got.items()}
    assert _rel(float(m["loss"]), m_j["loss"]) <= 1e-4
    assert _rel(float(m["ate"]), m_j["ate"]) <= 1e-4
    assert _rel(float(m["gnorm"]), m_j["gnorm"]) <= 1e-3
    worst = _check_grads(got, g_j, lambda n: DBA_TOL,
                         floor_names=("update.flow_encoder.0.bias",
                                      "update.flow_encoder.2.bias"))
    # the solver-facing heads, by name
    for n in ("update.weight.2.weight", "update.agg.eta.0.weight"):
        assert float(got[n].abs().max()) > 0
        assert float((got[n] - g_j[n]).abs().max()) \
            <= DBA_TOL * float(g_j[n].abs().max()), n
    print(f"dba step: loss {float(m['loss'])} vs {m_j['loss']}, ate "
          f"{float(m['ate'])} vs {m_j['ate']}, gnorm {float(m['gnorm'])} vs "
          f"{m_j['gnorm']}, worst gradient gap {worst:.2e}")


def test_optimizer_matches_optax():
    """make_optimizer against optax.chain(clip_by_global_norm(1.0),
    adamw(cosine_decay_schedule(lr, steps, 0.05))) on the same gradient
    sequence: 6 updates over a 4-step schedule (the cap at `steps`), the
    third with global norm above 1 (the clip), one tensor with no gradient
    at the fifth (optax still decays it)."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    P = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr, steps = 1e-2, 4
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(lr, steps, 0.05)))
    sched = optax.cosine_decay_schedule(lr, steps, 0.05)
    pj = {k: jnp.asarray(v) for k, v in P.items()}
    state = tx.init(pj)

    module = torch.nn.Module()
    for k, v in P.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    opt = T.make_optimizer(module, lr, steps)
    for t in range(6):
        scale = 3.0 if t == 2 else 0.1
        G = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        if t == 4:
            G["b"] = np.zeros(shapes["b"], np.float32)
        assert opt.opt.param_groups[0]["lr"] == pytest.approx(
            float(sched(t)), rel=1e-6)
        gn = float(optax.global_norm({k: jnp.asarray(v) for k, v in G.items()}))
        upd, state = tx.update({k: jnp.asarray(v) for k, v in G.items()},
                               state, pj)
        pj = optax.apply_updates(pj, upd)
        opt.zero_grad()
        for k, p in module.named_parameters():
            if not (t == 4 and k == "b"):
                p.grad = torch.tensor(G[k])
        gnorm = opt.step()
        assert float(gnorm) == pytest.approx(gn, rel=1e-6)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]),
                                       rtol=0, atol=1e-6)


def test_trainer_reduces_epe():
    """Mirrors the JAX suite's test_trainer_reduces_epe: pool=1 trains on
    one pre-rendered batch, so the first and last EPE are on the same
    data."""
    model, history = T.train(steps=8, batch=2, H=H, W=W, lr=4e-4,
                             ckpt_path=None, log_every=4, pool=1,
                             device="cpu")
    assert np.isfinite(history).all()
    assert history[-1] < history[0], history


def test_checkpoint_port_to_jax(jax_side, tmp_path):
    """A file the port writes is flax's own encoding of the init_params
    tree: byte-identical to flax.serialization.to_bytes, read by the JAX
    package's load_selftrained and by the port's tracker loader."""
    from flax import serialization
    model = _port_net(jax_side["P0"])
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    path = str(tmp_path / "port.msgpack")
    tweights.save_droid_params(model, path)
    tree = convert.droid_params_to_numpy(model)
    with open(path, "rb") as f:
        assert f.read() == serialization.to_bytes(tree)
    back = _np(J.load_selftrained(path))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax_side["P0"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(np.asarray, tree))):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    net = tweights.load_droid_params(path, device="cpu", dtype=torch.float32)
    assert net.weights_source == path
    for (n, a), b in zip(model.state_dict().items(),
                         net.state_dict().values()):
        assert torch.equal(a, b), n


def test_trainer_checkpoint_roundtrip_through_the_prefetcher(tmp_path):
    """Mirrors the JAX suite's test_trainer_checkpoint_roundtrip: streamed
    batches (pool=0, the worker threads), a checkpoint that reads back into
    the trained net, and no worker left running."""
    import threading
    ckpt = str(tmp_path / "droid.msgpack")
    before = set(threading.enumerate())
    model, _ = T.train(steps=2, batch=1, H=H, W=W, iters=1, ckpt_path=ckpt,
                       log_every=10, device="cpu")
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    back = tweights.load_selftrained(ckpt, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), n


def test_checkpoint_jax_to_port(jax_side):
    """JAX train(steps=1) writes; the port's load_selftrained reads it into
    a trainable float32 net holding the same parameters."""
    net = tweights.load_selftrained(jax_side["ckpt"], device="cpu")
    assert net.training and net.dtype == torch.float32
    assert all(p.requires_grad for p in net.parameters())
    want = convert.droid_params_from_numpy(jax_side["trained"])
    for n, t in net.state_dict().items():
        assert torch.equal(t, want[n]), n


def test_init_params_is_flax_lecun_normal():
    """init_params: kernels a truncated normal of variance 1/fan_in (flax's
    lecun_normal), biases zero; the same generator seed, the same net."""
    a = tweights.init_params(torch.Generator().manual_seed(5), device="cpu")
    b = tweights.init_params(torch.Generator().manual_seed(5), device="cpu")
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.requires_grad and torch.equal(p, q)
    w = a.update.gru.convq.weight                   # fan_in 448·9
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert float(w.detach().var()) == pytest.approx(1.0 / fan_in, rel=0.02)
    assert float(w.abs().max()) <= 2.0 / 0.8796256610342398 / fan_in ** 0.5
    assert all(float(m.bias.abs().max()) == 0 for m in a.modules()
               if isinstance(m, torch.nn.Conv2d))


def test_dba_step_moves_the_solver_heads():
    """Mirrors the JAX suite's test_dba_trainer_step_runs: one step gives a
    finite loss and ATE and moves the weight and eta heads (the BA
    gradients reach them)."""
    model = tweights.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")
    step = T.make_dba_train_step(model, T.make_optimizer(model, 1e-4, 10),
                                 N=N_SEQ, iters=2)
    batch = T.make_seq_batch(np.random.RandomState(0), 1, N_SEQ, H, W)
    w0 = model.update.weight[2].weight.detach().clone()
    e0 = model.update.agg.eta[0].weight.detach().clone()
    m = step(*batch)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["ate"]))
    assert float(m["gnorm"]) > 0
    assert float((model.update.weight[2].weight - w0).abs().max()) > 0
    assert float((model.update.agg.eta[0].weight - e0).abs().max()) > 0


def test_dba_with_all_zero_weights_has_finite_gradients():
    """All-zero confidence weights (the JAX verify recipe's probe): the
    pose system is its damping alone; the solve and its gradients stay
    finite in both packages."""
    N, h, w = 4, 6, 8
    rng = np.random.RandomState(2)
    ii, jj = T.seq_edges(N)
    E = len(ii)
    poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.float32), (N, 1))
    poses[:, :3] = 0.05 * rng.randn(N, 3)
    disps = (0.5 + rng.rand(N, h, w)).astype(np.float32)
    intr = np.array([10.0, 10.0, 4.0, 3.0], np.float32)
    target = (4 * rng.rand(E, h, w, 2)).astype(np.float32)
    weight = np.zeros((E, h, w, 2), np.float32)
    eta = np.full((N, h, w), 1e-3, np.float32)

    ts = [torch.tensor(x, requires_grad=True)
          for x in (poses, disps, target, weight, eta)]
    p, d = tba.dba(ts[0], ts[1], torch.tensor(intr), ts[2], ts[3], ts[4],
                   torch.zeros(N, h, w), tba.make_edges(ii, jj, 1, N),
                   iters=2)
    (p.sum() + d.sum()).backward()
    assert torch.isfinite(p).all() and torch.isfinite(d).all()
    for t in ts:
        assert torch.isfinite(t.grad).all()

    plan = jba.make_edge_plan(ii, jj, t0=1, t1=N)
    pad = len(plan.ii) - E

    def f(poses, disps, target, weight, eta):
        z = lambda a: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:])])
        p, d = jba.dba(poses, disps, jnp.asarray(intr), z(target), z(weight),
                       eta[plan.kx], jnp.zeros((N, h, w)), plan, iters=2)
        return p.sum() + d.sum()

    grads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(x) for x in (poses, disps, target, weight, eta)])
    for g in grads:
        assert np.isfinite(np.asarray(g)).all()


def test_pose_loss_gradient_is_finite_at_identity():
    """The pose loss takes lie.log of the error; at round 0 it can be the
    identity exactly, where sqrt and atan2 have singular derivatives."""
    g = torch.tensor([[0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0]],
                     requires_grad=True)
    err = tlie.log(tlie.mul(g, tlie.inv(g.detach())))
    assert float(err.abs().max()) == 0
    T._abs(err).mean().backward()
    assert torch.isfinite(g.grad).all()


def test_train_droid_cli_runs_both_stages(tmp_path):
    """python -m splatslam_tpu_torch.train_droid at a tiny size on the CPU:
    both stages, the second from the first's file, each file readable by
    the tracker's loader."""
    from splatslam_tpu_torch import train_droid
    out, dba_out = str(tmp_path / "flow.msgpack"), str(tmp_path / "dba.msgpack")
    assert train_droid.main([
        "--stage", "both", "--steps", "2", "--batch", "1", "--dba-steps",
        "1", "--dba-batch", "1", "--pool", "1", "--buckets", "small",
        "--out", out, "--dba-out", dba_out, "--device", "cpu"]) == 0
    for path in (out, dba_out):
        net = tweights.load_droid_params(path, device="cpu",
                                         dtype=torch.float32)
        assert net.weights_source == path
    assert not os.path.exists(os.path.join(tmp_path, "pretrained"))
