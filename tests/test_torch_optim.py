"""The port's learning-rate schedules and optimizers against the JAX
package's (optax), on the CPU.

Each schedule, with and without warm-up, at a list of steps around its
boundaries: the port's Python floats equal JAX's float32 values to float32
rounding. Each of the four optimizers, with and without the
`update_part` mask, with the per-leaf clip biting on one leaf: three steps
on a small tree (the same gradients for both), the updates within 1e-6 of
each leaf's largest update (Adam's within 5e-5: JAX computes its bias
corrections 1 - b^t in float32, where 1 - 0.999^t cancels to a relative
error of up to ulp(1) / (1 - 0.999^t) = 6e-5 at t = 1, halved by the square
root; the port computes them in float64), frozen leaves bit-identical and
stateless.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolov3_tensorflow_tpu.config import Config as JaxConfig
from yolov3_tensorflow_tpu.train import optimizers as jopt
from yolov3_tensorflow_tpu.train import schedules as jsched
from yolov3_tensorflow_tpu_torch.config import Config
from yolov3_tensorflow_tpu_torch.train import optimizers as topt
from yolov3_tensorflow_tpu_torch.train import schedules as tsched
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

torch.set_num_threads(CPU_TEST_THREADS)

STEPS = [0, 1, 2, 5, 9, 10, 11, 19, 20, 29, 30, 31, 49, 50, 51, 99, 100,
         101, 250, 1000]


def same_schedule(port, jax_fn):
    """Equal to float32 rounding: within 1e-6 relative, or 1e-6 of the
    schedule's largest value where float32 rounding of a cosine's argument
    or its cancellation near the end of the cosine dominates."""
    want = [float(jax_fn(jnp.asarray(step, jnp.int32))) for step in STEPS]
    scale = max(abs(w) for w in want)
    for step, w in zip(STEPS, want):
        got = port(step)
        assert isinstance(got, float)
        assert got == pytest.approx(w, rel=1e-6, abs=1e-6 * scale), step


SCHEDULES = {
    "fixed": (lambda m: m.fixed(1e-3),),
    "exponential": (lambda m: m.exponential(1e-2, 10, 0.5, 2e-3),),
    "cosine": (lambda m: m.cosine(1e-2, 100, 1e-4),),
    "cosine_restarts": (lambda m: m.cosine_restarts(1.0, 10, t_mul=2.0),),
    "cosine_restarts_t1": (lambda m: m.cosine_restarts(1.0, 10, t_mul=1.0,
                                                       m_mul=0.5,
                                                       alpha=0.1),),
    "piecewise": (lambda m: m.piecewise([30.0, 50.0], [1e-4, 3e-5, 1e-5]),),
}


@pytest.mark.parametrize("warmup", [0, 10])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name, warmup):
    make = SCHEDULES[name][0]
    port, jfn = make(tsched), make(jsched)
    if warmup:
        port = tsched.with_warmup(port, 1e-2, warmup)
        jfn = jsched.with_warmup(jfn, 1e-2, warmup)
    same_schedule(port, jfn)


@pytest.mark.parametrize("lr_type", ["fixed", "exponential", "cosine_decay",
                                     "cosine_decay_restart", "piecewise"])
def test_build_schedule_matches_jax(lr_type):
    cfgs = []
    for cls in (Config, JaxConfig):
        cfg = cls()
        cfg.train.lr_type = lr_type
        cfg.train.warm_up_epoch = 2
        cfg.train.total_epochs = 40
        cfg.train_batch_num = 5              # as finalize() counts them
        cfg.lr_decay_freq = 25
        cfg.pw_boundaries_steps = (150.0, 250.0)
        cfgs.append(cfg)
    same_schedule(tsched.build_schedule(cfgs[0]),
                  jsched.build_schedule(cfgs[1]))


def _tree(seed):
    """A small param tree of both packages' shape conventions (numpy)."""
    rng = np.random.default_rng(seed)
    return {"backbone": {"conv_0": {"w": rng.normal(size=(3, 3, 2, 4)),
                                    "gamma": rng.normal(size=4),
                                    "beta": rng.normal(size=4)}},
            "head": {"conv_0": {"w": rng.normal(size=(1, 1, 4, 5)),
                                "gamma": rng.normal(size=5),
                                "beta": rng.normal(size=5)},
                     "conv_6": {"w": rng.normal(size=(1, 1, 5, 6)),
                                "b": rng.normal(size=6)}}}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("update_part", [None, ("head",), ("head/conv_6",)])
@pytest.mark.parametrize("name", ["sgd", "momentum", "rmsprop", "adam"])
def test_optimizer_matches_optax(name, update_part):
    params = _f32(_tree(0))
    grads = [_f32(_tree(s)) for s in (1, 2, 3)]
    # one leaf's gradient far above the clip norm: the clip must bite
    for g in grads:
        g["head"]["conv_0"]["w"] = g["head"]["conv_0"]["w"] * 100.0
    sched_j = jsched.with_warmup(jsched.fixed(0.1), 0.1, 2)
    sched_t = tsched.with_warmup(tsched.fixed(0.1), 0.1, 2)

    jmask = jopt.path_prefix_mask(params, update_part)
    tx = jopt.build_optimizer(name, sched_j, momentum=0.9,
                              rmsprop_decay=0.9, grad_clip_norm=10.0,
                              update_mask=jmask if update_part else None)
    tmask = topt.path_prefix_mask(params, update_part)
    assert tmask == {p: m for p, m in topt.flatten(jmask).items()}
    opt = topt.build_optimizer(name, sched_t, momentum=0.9,
                               rmsprop_decay=0.9, grad_clip_norm=10.0,
                               update_mask=tmask if update_part else None)

    rtol = 5e-5 if name == "adam" else 1e-6
    slack = {}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    tstate = opt.init(tparams)
    trainable = opt.trainable(tparams)
    for slot in topt.SLOTS[name]:
        assert set(tstate[slot]) == set(trainable)
    for step, g in enumerate(grads):
        ju, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                               jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tg = topt.flatten(jax.tree_util.tree_map(torch.from_numpy, g))
        tu, tstate = opt.update({p: tg[p] for p in trainable}, tstate)
        assert tstate["count"] == step + 1
        before = tparams
        tparams = topt.apply_updates(tparams, tu)
        jflat = topt.flatten(jax.device_get(ju))
        for path, want in jflat.items():
            want = np.asarray(want)
            if path not in trainable:
                assert path not in tu and not want.any()
                assert topt.flatten(tparams)[path] is \
                    topt.flatten(before)[path]
                continue
            got = tu[path].numpy()
            if step == 0:           # warm-up from 0: the first update is 0
                assert not got.any() and not want.any()
                continue
            scale = np.abs(want).max()
            assert scale > 0
            np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                       err_msg=f"{name} step {step} {path}")
            slack[path] = slack.get(path, 0.0) + rtol * scale
    # the params: their float32 rounding plus the updates' tolerances
    for path, want in topt.flatten(jax.device_get(jparams)).items():
        want = np.asarray(want)
        np.testing.assert_allclose(
            topt.flatten(tparams)[path].numpy(), want, rtol=0,
            atol=1e-6 * np.abs(want).max() + slack.get(path, 0.0))


@pytest.mark.parametrize("name", ["sgd", "momentum", "rmsprop", "adam"])
def test_update_mask_matching_no_leaf(name):
    """`train.update_part=None` parses to ("None",) in both packages'
    configs (the JAX two-process test trains so): a mask of no leaf. JAX
    updates nothing; the port's update returns no updates and counts the
    step, instead of failing on an empty list of leaves."""
    params = _f32(_tree(0))
    jmask = jopt.path_prefix_mask(params, ("None",))
    assert not any(jax.tree_util.tree_leaves(jmask))
    tx = jopt.build_optimizer(name, jsched.fixed(0.1), grad_clip_norm=10.0,
                              update_mask=jmask)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    ju, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, _f32(_tree(1))),
                      tx.init(jparams), jparams)
    assert not any(np.asarray(u).any()
                   for u in jax.tree_util.tree_leaves(ju))
    tparams = jax.tree_util.tree_map(torch.from_numpy, params)
    opt = topt.build_optimizer(name, tsched.fixed(0.1), grad_clip_norm=10.0,
                               update_mask=topt.path_prefix_mask(
                                   tparams, ("None",)))
    assert opt.trainable(tparams) == []
    state = opt.init(tparams)
    tu, state = opt.update({}, state)
    assert tu == {} and state["count"] == 1
    assert topt.flatten(topt.apply_updates(tparams, tu)).keys() == \
        topt.flatten(tparams).keys()


def test_clip_by_per_leaf_norm_matches_jax():
    grads = {"a": np.asarray([3.0, 4.0], np.float32),
             "b": np.asarray([0.1], np.float32),
             "c": np.zeros(3, np.float32)}
    tx = jopt.clip_by_per_leaf_norm(1.0)
    want, _ = tx.update(grads, tx.init(grads))
    got = topt.clip_by_per_leaf_norm(
        [torch.from_numpy(v) for v in grads.values()], 1.0)
    for g, k in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), [0.6, 0.8], rtol=1e-6)


def test_flatten_round_trip_and_unknown_optimizer():
    tree = _tree(4)
    flat = topt.flatten(tree)
    assert list(flat)[:3] == ["backbone/conv_0/w", "backbone/conv_0/gamma",
                              "backbone/conv_0/beta"]
    assert topt.unflatten(flat) == tree
    with pytest.raises(ValueError, match="unsupported optimizer"):
        topt.build_optimizer("lamb", tsched.fixed(1.0))
