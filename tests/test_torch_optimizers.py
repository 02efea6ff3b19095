"""The port's training zoo against the JAX package's: the optimizer
factories (tests/test_optimizers.py), the EMA, the two-network step
(tests/test_aux.py:127-150) and the swarm trainer's choice of unit, on the
same gradients, batches and ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tha4_tpu.training import ema as jema
from tha4_tpu.training import optimizers as joptimizers
from tha4_tpu.training import swarm as jswarm
from tha4_tpu.training import two_networks as jtwo_networks
from tha4_tpu_torch.parallel import mesh
from tha4_tpu_torch.training import ema, optimizers, swarm, two_networks
from tha4_tpu_torch.training import trainer as trainer_lib

STEPS, LR = 6, 0.01


def _gradients(zeros: bool = False):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(STEPS)]
    if zeros:  # a different third of the entries zero at each step, and one step all zero
        for i, g in enumerate(grads):
            g[(np.arange(12).reshape(4, 3) + i) % 3 == 0] = 0.0
        grads[2][:] = 0.0
    return p0, grads


def _run_pair(factory, jfactory, zeros: bool = False):
    """The port's optimizer and the JAX factory from one start over the same
    gradients, the lr set before each step; the parameters after every
    step and the final moments."""
    p0, grads = _gradients(zeros)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer = factory.create([param])
    params = {"w": jnp.asarray(p0)}
    state = jfactory.init(params)
    for i, g in enumerate(grads):
        lr = LR * (1 + i % 2)  # the caller's lr changes between steps
        param.grad = torch.from_numpy(g.copy())
        optimizers.set_lr(optimizer, lr)
        optimizer.step()
        params, state = jfactory.update({"w": jnp.asarray(g)}, state, params, lr)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(params["w"]), rtol=2e-6, atol=5e-7, err_msg=f"step {i}")
    return optimizer.state[param], state


@pytest.mark.parametrize("name", ["Adam", "AdamW", "RMSprop"])
def test_factories_match_jax(name):
    """Adam with L2 decay in the gradient, AdamW's decoupled decay and
    RMSprop are torch.optim's own, step for step equal to the JAX rules at
    tests/test_optimizers.py's bars."""
    kwargs = {"Adam": dict(weight_decay=0.05), "AdamW": {}, "RMSprop": {}}[name]
    factory = getattr(optimizers, f"{name}Factory")(**kwargs)
    expected = {"Adam": torch.optim.Adam, "AdamW": torch.optim.AdamW, "RMSprop": torch.optim.RMSprop}[name]
    assert type(factory.create([torch.nn.Parameter(torch.zeros(1))])) is expected
    _run_pair(factory, getattr(joptimizers, f"{name}Factory")(**kwargs))


def test_sparse_adam_on_dense_gradients_matches_jax():
    """SparseAdam on dense (all nonzero) gradients: JAX's masked Adam, and
    torch.optim.Adam's update (tests/test_optimizers.py:61-69)."""
    ours, theirs = _run_pair(optimizers.SparseAdamFactory(), joptimizers.SparseAdamFactory())
    np.testing.assert_allclose(ours["exp_avg"].numpy(), np.asarray(theirs.mu["w"]), rtol=1e-6)
    np.testing.assert_allclose(ours["exp_avg_sq"].numpy(), np.asarray(theirs.nu["w"]), rtol=1e-6)
    assert int(ours["step"]) == int(theirs.steps["w"]) == STEPS
    with pytest.raises(RuntimeError):  # why the factory is not torch.optim.SparseAdam
        param = torch.nn.Parameter(torch.zeros(3))
        param.grad = torch.ones(3)
        torch.optim.SparseAdam([param]).step()


def test_sparse_adam_masks_zero_gradients_as_jax():
    """Where a gradient is zero the parameter and both moments keep their
    values (a step whose gradient is all zero moves nothing), the step count
    advances every step, and the whole run equals JAX's."""
    ours, theirs = _run_pair(optimizers.SparseAdamFactory(), joptimizers.SparseAdamFactory(), zeros=True)
    np.testing.assert_allclose(ours["exp_avg"].numpy(), np.asarray(theirs.mu["w"]), rtol=1e-6)
    assert int(ours["step"]) == STEPS
    param = torch.nn.Parameter(torch.ones(2, 2))
    optimizer = optimizers.SparseAdamFactory().create([param])
    param.grad = torch.tensor([[1.0, 0.0], [0.0, -1.0]])
    optimizers.set_lr(optimizer, 0.1)
    optimizer.step()
    w, mu = param.detach().numpy(), optimizer.state[param]["exp_avg"].numpy()
    assert w[0, 1] == 1.0 and w[1, 0] == 1.0 and w[0, 0] != 1.0 and w[1, 1] != 1.0
    assert mu[0, 1] == 0.0 and mu[0, 0] != 0.0


def test_ema_matches_jax():
    rng = np.random.default_rng(1)
    module = torch.nn.Linear(3, 2)
    average = ema.init(module)
    assert not any(p.requires_grad for p in average.parameters())
    # Copies: jnp.asarray may alias a numpy buffer, and the module's are overwritten below.
    params = {k: jnp.asarray(v.detach().numpy().copy()) for k, v in module.named_parameters()}
    javerage = jema.init(params)
    for _ in range(5):
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        ema.update(average, module, decay=0.9)
        javerage = jema.update(javerage, {k: jnp.asarray(v.detach().numpy().copy()) for k, v in module.named_parameters()},
                               decay=0.9)
    for k, v in average.named_parameters():
        np.testing.assert_allclose(v.numpy(), np.asarray(javerage[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_two_network_step_matches_jax():
    """tests/test_aux.py:127-150: A fits y = 2x, B fits y = A(x) + 1, B held
    while A steps and the updated A held while B steps.  The same 200
    batches through both packages: the fit, and both trajectories within
    f32 rounding of each other."""

    class Scalar(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(()))

    def loss_a(a, b, batch):
        return ((a.w * batch["x"] - batch["y"]) ** 2).mean(), {}

    def loss_b(a, b, batch):
        return ((b.w * (a.w * batch["x"]) - (batch["y"] + 1.0)) ** 2).mean(), {"fit": (b.w - 1.0).abs()}

    def jloss_a(pa, pb, batch):
        return ((pa["w"] * batch["x"] - batch["y"]) ** 2).mean(), {}

    def jloss_b(pa, pb, batch):
        return ((pb["w"] * (pa["w"] * batch["x"]) - (batch["y"] + 1.0)) ** 2).mean(), {"fit": jnp.abs(pb["w"] - 1.0)}

    a, b = Scalar(), Scalar()
    opt_a, opt_b = two_networks.init_two_network_state(a, b)
    step = two_networks.make_two_network_step(loss_a, loss_b)
    pa, pb = {"w": jnp.zeros(())}, {"w": jnp.zeros(())}
    oa, ob = jtwo_networks.init_two_network_state(pa, pb)
    jstep = jtwo_networks.make_two_network_step(jloss_a, jloss_b)
    rng = np.random.default_rng(0)
    for i in range(200):
        x = rng.standard_normal(16).astype(np.float32)
        metrics = step(a, opt_a, b, opt_b, {"x": torch.from_numpy(x), "y": torch.from_numpy(2 * x)}, 0.05, 0.05)
        pa, oa, pb, ob, jmetrics = jstep(pa, oa, pb, ob, {"x": jnp.asarray(x), "y": jnp.asarray(2 * x)}, 0.05, 0.05)
        if i < 20:
            np.testing.assert_allclose(a.w.item(), float(pa["w"]), rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
            np.testing.assert_allclose(b.w.item(), float(pb["w"]), rtol=1e-5, atol=1e-6, err_msg=f"step {i}")
    assert metrics.keys() == jmetrics.keys() == {"loss_a", "loss_b", "b_fit"}
    assert abs(a.w.item() - 2.0) < 0.2 and float(metrics["loss_b"]) < 1.5
    np.testing.assert_allclose(a.w.item(), float(pa["w"]), rtol=1e-3)
    np.testing.assert_allclose(b.w.item(), float(pb["w"]), rtol=1e-3)


class _Unit:
    def __init__(self, unit, log, cfg):
        self.unit, self.log, self.cfg = unit, log, cfg

    def train(self, target_examples=None):
        self.log.append((self.unit, target_examples, (mesh.is_distributed(), mesh.rank(), mesh.world_size())))
        return self.unit


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_swarm_picks_the_unit_of_its_rank_as_jax(monkeypatch, rank):
    """Units 0, 1 and 3, in rank ``rank`` of a process group of 4: rank r
    trains unit r alone (inside, the process is rank 0 of a world of one,
    outside the group's data parallelism), a rank with no unit idles, and
    ``train_all`` runs every unit in order; the JAX swarm by process index
    does the same."""
    cfg = trainer_lib.TrainerConfig(prefix="unused", checkpoint_examples=[8])
    logs = {"port": [], "jax": []}
    units = (0, 1, 3)
    ours = swarm.SwarmTrainer({u: (lambda u=u: _Unit(u, logs["port"], cfg)) for u in units})
    theirs = jswarm.SwarmTrainer({u: (lambda u=u: _Unit(u, logs["jax"], cfg)) for u in units})
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    assert (mesh.rank(), mesh.world_size()) == (rank, 4)
    assert ours.train_process_unit(16) == theirs.train_process_unit(16) == (rank if rank in units else None)
    assert ours.train_all() == theirs.train_all() == {u: u for u in units}
    ran = [rank] if rank in units else []
    assert [u for u, _, _ in logs["port"]] == [u for u, _, _ in logs["jax"]] == ran + list(units)
    assert all(world == (False, 0, 1) for _, _, world in logs["port"]) and logs["port"][0][1] == (16 if ran else None)
    assert (mesh.rank(), mesh.world_size()) == (rank, 4)
