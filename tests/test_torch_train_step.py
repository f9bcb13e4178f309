"""The port's train step against the JAX trainer's on the same bridged weights and batch.

* loss and gradients of ARPDT, BC and GCBC: ``jax.value_and_grad`` of
  arp_tpu's ``make_loss_fn`` (augmentation fused in) against the port's loss
  and backward, the augmentation replaying JAX's draws: loss within 1e-5,
  every gradient within 1e-4 of the largest entry;
* the optax-exact AdamW (train/common.py) fed identical gradients over three
  steps across the warmup, with the clip engaged and not: params within 1e-6;
* one whole step of arp_tpu's ``make_train_step`` (accum_steps 1 and 2, the
  explicit L2 penalty) against the port's: updated params within 2e-5 at
  lr 5e-4.  Entries whose gradient is below 1e-7 are left out of that
  comparison: Adam's first step moves each entry by +-lr on the sign of its
  gradient alone, and a gradient that small has no sign both sides share;
* the aux keys, and the generator's seed deciding the augmentation;
* the attention's dispatch rule, and K1's autograd function's backward (on the CPU, with
  the plain attention standing in for the kernel's forward).
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from arp_tpu.models import m3ae as jm3ae
from arp_tpu.models.policy import models as jpol
from arp_tpu.ops import augment as jaug
from arp_tpu.parallel import step as jstep
from arp_tpu.train import common as jcommon
from arp_tpu_torch.config import Config
from arp_tpu_torch.models.policy import convert
from arp_tpu_torch.models.policy import models as tpol
from arp_tpu_torch.ops import attention as tattn
from arp_tpu_torch.ops import augment as taug
from arp_tpu_torch.ops.masks import MaskSpec
from arp_tpu_torch.parallel import step as tstep
from arp_tpu_torch.train import common as tcommon
from test_torch_train_augment import jax_draws

IMG, PATCH, WINDOW, BATCH = 32, 16, 2, 4
TOWER = dict(model_type=None, emb_dim=64, dec_emb_dim=16, depth=2, dec_depth=1, num_heads=4, dec_num_heads=4,
             mlp_ratio=2)
AUGS = "random_crop,color_jitter"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tower():
    """A seeded 2-layer, 64-wide M3AE tower in the Flax layout and the port's."""
    model = jm3ae.MaskedMultimodalAutoencoder(config_updates=dict(TOWER), text_vocab_size=jpol.BERT_VOCAB_SIZE)
    probe = jnp.zeros((1, (IMG // PATCH) ** 2, PATCH * PATCH * 3), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(7)}, probe, jnp.zeros((1, 8), jnp.int32),
                           jnp.zeros((1, 8), jnp.float32), method=model.forward_representation, deterministic=True)
    rng = np.random.default_rng(8)
    variables = jax.tree_util.tree_map(lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape)
                                                              .astype(np.float32)), variables)
    return variables, convert.flax_m3ae_to_torch(jax.device_get(variables))


def policy_config(**over):
    cfg = dict(model_type="vit_debug", transfer_type="m3ae_vit_b16", use_adapter=True, emb_dim=32, depth=2,
               num_heads=4, mlp_ratio=2, use_discrete_action=True, num_ensembles=2, m3ae=dict(TOWER))
    cfg.update(over)
    return cfg


def make_batch(seed, with_goal=False):
    rng = np.random.default_rng(seed)
    batch = {"image": {"ob": rng.integers(0, 256, size=(BATCH, WINDOW, IMG, IMG, 3), dtype=np.uint8)},
             "rtg": {"ob": rng.uniform(0, 2, size=(BATCH, WINDOW, 1)).astype(np.float32)},
             "action": rng.integers(0, 15, size=(BATCH, WINDOW)).astype(np.int32),
             "instruct": None, "text_padding_mask": None, "goal": None}
    if with_goal:
        batch["goal"] = {"ob": rng.integers(0, 256, size=(BATCH, WINDOW, IMG, IMG, 3), dtype=np.uint8)}
    return batch


def build_pair(cls, cfg, batch, tower, monkeypatch, seed=21):
    """The Flax policy with seeded weights and the port's with the same weights: (jmodel, params, tmodel)."""
    jvars, tvars = tower
    monkeypatch.setattr(jm3ae, "load_m3ae_model_vars", lambda name, checkpoint_dir=None: jvars)
    jmodel = getattr(jpol, cls)(config_updates=cfg, num_actions=15, patch_dim=PATCH)
    probe = jax.tree_util.tree_map(jnp.asarray, dict(batch, image={"ob": batch["image"]["ob"].astype(np.float32)},
                                                     goal=None if batch["goal"] is None else
                                                     {"ob": batch["goal"]["ob"].astype(np.float32)}))
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, probe, deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape)
                                                          .astype(np.float32)), params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tmodel = getattr(tpol, cls)(cfg, num_actions=15, patch_dim=PATCH, pt_variables=tvars)
    with torch.no_grad():
        tmodel(dict(probe and batch), deterministic=True)  # the lazy layers take their shapes
        tmodel.load_trained_state_dict(convert.flax_policy_to_torch(jax.device_get(params)))
    return jmodel, params, tmodel


class Replay:
    """The port's augment_fn for a test: applies JAX's draws, one list a call, in call order."""

    def __init__(self, draws):
        self.aug, self.draws = taug.make_augment_fn(AUGS, IMG, IMG), iter(draws)

    def __call__(self, images, generator):
        return self.aug.apply(images, next(self.draws))


def loss_draws(rng, batch, use_goal):
    """JAX make_loss_fn's augmentation keys, in the port's call order: the views, then the goals'."""
    _, aug_rng = jax.random.split(rng)
    n = int(np.prod(next(iter(batch["image"].values())).shape[:2]))
    draws = [jax_draws(jax.random.fold_in(aug_rng, i), n, AUGS, IMG, IMG) for i, _ in enumerate(sorted(batch["image"]))]
    if use_goal:
        goal_rng = jax.random.fold_in(aug_rng, 977)
        draws += [jax_draws(jax.random.fold_in(goal_rng, i), n, AUGS, IMG, IMG) for i, _ in enumerate(sorted(batch["goal"]))]
    return draws


def grads_by_name(tmodel):
    return {n: p.grad for n, p in tstep.trainable_parameters(tmodel)}


CASES = {"arpdt": ("ARPDT", {}, False), "bc": ("BC", dict(transfer_type="none", use_adapter=False), False),
         "gcbc": ("GCBC", {}, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case, tower, monkeypatch):
    cls, over, use_goal = CASES[case]
    batch = make_batch(1, with_goal=use_goal)
    jmodel, params, tmodel = build_pair(cls, policy_config(**over), batch, tower, monkeypatch)
    rng = jax.random.PRNGKey(5)
    jloss_fn = jcommon.make_loss_fn(jmodel, jaug.make_augment_fn(AUGS, image_size=IMG, source_size=IMG), IMG, use_goal)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(params, jax.tree_util.tree_map(jnp.asarray, batch), rng)

    tloss_fn = tcommon.make_loss_fn(tmodel, Replay(loss_draws(rng, batch, use_goal)), IMG, use_goal)
    tloss, taux = tloss_fn(tmodel, batch, torch.Generator().manual_seed(0))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    for key in ("acc", "trans_loss", "return_loss"):
        assert abs(float(taux[key]) - float(jaux[key])) <= 1e-4, key
    want = convert.flax_policy_to_torch(jax.device_get(jgrads))
    got = grads_by_name(tmodel)
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert float((got[name] - g).abs().max()) <= 1e-4 * scale, name


class _NoDecay:
    def __init__(self, names):
        self.names = names

    def no_decay_list(self):
        return self.names


@pytest.mark.parametrize("clip", [1e9, 0.5])
@pytest.mark.parametrize("no_decay", [[], ["bias"]])
def test_adamw_matches_optax_on_identical_gradients(clip, no_decay):
    """Three steps across a 2-step warmup; the clip engaged (0.5) and not; the no-decay mask."""
    shapes = {"a.kernel": (5, 7), "a.bias": (7,), "heads.kernel": (3, 4, 2)}
    rng = np.random.default_rng(0)
    p0 = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    flags = SimpleNamespace(clip_gradient=clip, weight_decay=5e-5)
    sched_j = optax.warmup_cosine_decay_schedule(0.0, 5e-4, 2, 10, 0.0)
    sched_t = tcommon.warmup_cosine_decay_schedule(0.0, 5e-4, 2, 10, 0.0)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(
        sched_j, weight_decay=5e-5, b1=0.9, b2=0.999,
        mask={n: not any(nd in part for nd in no_decay for part in n.split(".")) for n in shapes}))
    pj = {n: jnp.asarray(v) for n, v in p0.items()}
    st = tx.init(pj)
    params = [(n, torch.tensor(v)) for n, v in p0.items()]
    opt = tcommon.build_optimizer(flags, sched_t, _NoDecay(no_decay), params=params)
    assert opt.decay == [n != "a.bias" or not no_decay for n in shapes]
    ost = opt.init([p for _, p in params])
    for step in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32) * 3 for n, s in shapes.items()}
        u, st = tx.update({n: jnp.asarray(v) for n, v in g.items()}, st, pj)
        pj = optax.apply_updates(pj, u)
        ost = opt.update([p for _, p in params], [torch.tensor(g[n]) for n, _ in params], ost)
        assert sched_t(step) == pytest.approx(float(sched_j(step)), rel=1e-6, abs=1e-12)
        for n, p in params:
            np.testing.assert_allclose(p.numpy(), np.asarray(pj[n]), atol=1e-6, rtol=0, err_msg=f"{n} step {step}")
    assert ost.count == 3


def test_schedules_match_optax():
    flags = SimpleNamespace(lr=5e-4, warmup_epochs=2.0, lr_schedule="cos")
    for kind in ("cos", "fixed", "cos_decay"):
        flags.lr_schedule = kind
        want, got = jcommon.build_lr_schedule(flags, 5, 40), tcommon.build_lr_schedule(flags, 5, 40)
        for count in (0, 1, 5, 9, 10, 11, 25, 39, 40, 45):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), (kind, count)
    flags.warmup_epochs = 100.0  # warmup capped below total_steps, as in JAX
    assert tcommon.build_lr_schedule(flags, 5, 40)(39) == pytest.approx(float(jcommon.build_lr_schedule(flags, 5, 40)(39)))


def _jax_state(jmodel, params, flags, lr):
    return JTrainState.create(apply_fn=jmodel.apply, params=params, tx=jcommon.build_optimizer(flags, lr, jmodel))


@pytest.mark.parametrize("accum,l2", [(1, False), (2, False), (2, True)])
def test_one_step_matches_jax_make_train_step(accum, l2, tower, monkeypatch):
    batch = make_batch(2)
    jmodel, params, tmodel = build_pair("ARPDT", policy_config(), batch, tower, monkeypatch)
    flags = SimpleNamespace(clip_gradient=10.0, weight_decay=5e-5, lr=5e-4, lr_schedule="fixed", warmup_epochs=0)
    jlr = jcommon.build_lr_schedule(flags, 10, 100)
    jaugment = jaug.make_augment_fn(AUGS, image_size=IMG, source_size=IMG)
    jtrain = jstep.make_train_step(jcommon.make_loss_fn(jmodel, jaugment, IMG, False), None,
                                   weight_decay=5e-5 if l2 else 0.0, learning_rate_fn=jlr, accum_steps=accum,
                                   donate=False)
    rng = jax.random.PRNGKey(9)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate, jaux = jtrain(_jax_state(jmodel, params, flags, jlr), jbatch, rng)
    # the gradient JAX's step applies (an SGD step of rate 1 through the same step function)
    sgd = JTrainState.create(apply_fn=jmodel.apply, params=params, tx=optax.sgd(1.0))
    jgrads = jax.tree_util.tree_map(lambda a, b: a - b, params, jtrain(sgd, jbatch, rng)[0].params)

    mb_keys = [rng] if accum == 1 else [jax.random.fold_in(rng, i) for i in range(accum)]
    mb = [{k: (None if v is None else {kk: vv.reshape(accum, -1, *vv.shape[1:])[i] for kk, vv in v.items()}
               if isinstance(v, dict) else v.reshape(accum, -1, *v.shape[1:])[i]) for k, v in batch.items()}
          for i in range(accum)]
    draws = [d for key, b in zip(mb_keys, mb) for d in loss_draws(key, b, False)]
    tflags = Config(clip_gradient=10.0, weight_decay=5e-5, lr=5e-4, lr_schedule="fixed", warmup_epochs=0)
    tlr = tcommon.build_lr_schedule(tflags, 10, 100)
    state = tstep.TrainState.create(tmodel, tcommon.build_optimizer(tflags, tlr, tmodel))
    train = tstep.make_train_step(tcommon.make_loss_fn(tmodel, Replay(draws), IMG, False),
                                  weight_decay=5e-5 if l2 else 0.0, learning_rate_fn=tlr, accum_steps=accum)
    state, taux = train(state, batch, torch.Generator().manual_seed(0))

    assert set(taux) == set(jaux)
    for key in jaux:
        assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=1e-5, abs=1e-6), key
    want = convert.flax_policy_to_torch(jax.device_get(jstate.params))
    grads = convert.flax_policy_to_torch(jax.device_get(jgrads))
    got = dict(state.params)
    assert state.step == 1 and state.opt_state.count == 1
    for name, w in want.items():
        settled = grads[name].abs() > 1e-7  # Adam's first step moves the others by +-lr on their sign alone
        np.testing.assert_allclose((got[name].detach() * settled).numpy(), (w * settled).numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_aux_keys_and_the_seed(tower, monkeypatch):
    batch = make_batch(3)
    _, _, tmodel = build_pair("ARPDT", policy_config(), batch, tower, monkeypatch)
    start = {k: v.clone() for k, v in tmodel.trained_state_dict().items()}
    tflags = Config(clip_gradient=10.0, weight_decay=5e-5, lr=5e-4, lr_schedule="fixed", warmup_epochs=0)
    lr = tcommon.build_lr_schedule(tflags, 10, 100)
    results = []
    for seed in (0, 0, 1):
        tmodel.load_trained_state_dict(start)
        state = tstep.TrainState.create(tmodel, tcommon.build_optimizer(tflags, lr, tmodel))
        train = tstep.make_train_step(tcommon.make_loss_fn(tmodel, taug.make_augment_fn(AUGS, IMG, IMG), IMG, False),
                                      weight_decay=5e-5, learning_rate_fn=lr)
        state, aux = train(state, batch, torch.Generator().manual_seed(seed))
        results.append((float(aux["loss"]), [p.detach().clone() for _, p in state.params]))
    assert set(aux) == {"loss", "acc", "trans_loss", "return_loss", "weight_penalty", "weight_l2",
                        "train_state_step", "learning_rate"}
    assert aux["train_state_step"] == 0 and aux["learning_rate"] == pytest.approx(5e-4)
    assert results[0][0] == results[1][0] and all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    assert results[0][0] != results[2][0]  # another seed, other augmentations


def test_optimizer_needs_the_first_forward(tower):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = tpol.ARPDT(policy_config(), num_actions=15, patch_dim=PATCH, pt_variables=tower[1])
    with pytest.raises(RuntimeError, match="first forward"):
        tcommon.build_optimizer(Config(clip_gradient=1.0, weight_decay=0.0), lambda c: 1e-3, model)
    with torch.no_grad():
        model(make_batch(4), deterministic=True)
    names = [n for n, _ in tstep.trainable_parameters(model)]
    assert any(n.startswith("image_text_input.") for n in names) and any(n.startswith("AdapterMLP_0.") for n in names)
    assert not any(n.startswith("pt_model.") for n in names)  # the frozen tower is not trained


def test_l2_penalty_matches_jax(tower, monkeypatch):
    batch = make_batch(5)
    _, params, tmodel = build_pair("ARPDT", policy_config(), batch, tower, monkeypatch)
    want = float(jstep.l2_weight_penalty(params))
    got = float(tstep.l2_weight_penalty(tstep.trainable_parameters(tmodel)))
    assert got == pytest.approx(want, rel=1e-6)


# -- K1's gradient: the dispatch rule and FlashAttention's backward ----------------------------

def test_attention_dispatch_rule():
    assert tattn.attention_route("cpu", needs_grad=True) == "plain"
    assert tattn.attention_route("cpu", needs_grad=False, bias=True) == "plain"
    assert tattn.attention_route("cuda", needs_grad=False) == "k1"
    assert tattn.attention_route("cuda", needs_grad=True) == "k1+plain_backward"
    with pytest.raises(NotImplementedError, match="bias"):
        tattn.attention_route("cuda", needs_grad=True, bias=True)
    with pytest.raises(ValueError):
        tattn.attention_route("mps", needs_grad=False)


@pytest.mark.parametrize("spec,padded", [(MaskSpec("dt", 1, 3), True), (MaskSpec("causal"), False),
                                         (MaskSpec("none"), False)])
def test_flash_attention_backward_is_the_plain_gradient(spec, padded, monkeypatch):
    """FlashAttention's backward, with the plain attention standing in for K1's forward (which,
    as the kernel's output does, carries no graph): the plain attention's own gradients, a fully
    padded row (the mean of V) included."""
    monkeypatch.setattr(tattn, "flash_attention_fwd",
                        lambda q, k, v, spec, pad: tattn.reference_attention(q.detach(), k.detach(), v.detach(), spec, pad))
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, 12, 4, 16, generator=gen, requires_grad=True) for _ in range(3))
    pad = None
    if padded:
        pad = torch.zeros(3, 12)
        pad[1] = 1.0
        pad[2, 7:] = 1.0
    g = torch.randn(3, 12, 4, 16, generator=gen)
    got = torch.autograd.grad(tattn.FlashAttention.apply(q, k, v, spec, pad), (q, k, v), g)
    want = torch.autograd.grad(tattn.reference_attention(q, k, v, spec, pad), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    only_v = torch.autograd.grad(tattn.FlashAttention.apply(q.detach(), k.detach(), v, spec, pad), (v,), g)[0]
    torch.testing.assert_close(only_v, want[2], atol=1e-6, rtol=0)


def test_frozen_amax_files_cross_between_the_packages(tmp_path):
    """save_frozen_amax / load_frozen_amax: one npz layout, written by either package, read by the other."""
    rng = np.random.default_rng(0)
    amax = {"img": np.float32(3.5), "layers": {s: rng.uniform(1, 4, size=2).astype(np.float32)
                                               for s in ("qkv", "attn_in", "attn_out", "fc", "proj")}}
    jcommon.save_frozen_amax(str(tmp_path / "j"), amax)
    tcommon.save_frozen_amax(str(tmp_path / "t"), {"img": torch.tensor(3.5),
                                                   "layers": {k: torch.from_numpy(v) for k, v in amax["layers"].items()}})
    for a, b in ((jcommon.load_frozen_amax(str(tmp_path / "t")), tcommon.load_frozen_amax(str(tmp_path / "j"))),):
        assert float(a["img"]) == float(b["img"]) == 3.5
        for k, v in amax["layers"].items():
            np.testing.assert_array_equal(a["layers"][k], v)
            np.testing.assert_array_equal(b["layers"][k], v)
    assert tcommon.load_frozen_amax(str(tmp_path / "none")) is None and tcommon.load_frozen_amax("") is None


def test_remat_with_dropout_replays_the_generator_s_draws():
    """A rematerialized Transformer draws its dropout masks from the caller's generator: its
    gradient equals the plain one's for the same seed, and the generator ends where the plain
    forward leaves it (the recomputation replays the forward's draws)."""
    from arp_tpu_torch.models import layers

    x = torch.randn(3, 6, 32, generator=torch.Generator().manual_seed(0))
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = layers.Transformer(32, depth=2, num_heads=4, mlp_ratio=2, drop=0.3, att_drop=0.2, remat=remat)
        gen = torch.Generator().manual_seed(5)
        xin = x.clone().requires_grad_(True)
        y = model(xin, deterministic=False, mask_spec=MaskSpec("causal"), generator=gen)
        grads = torch.autograd.grad(y.square().sum(), [xin, *model.parameters()])
        out[remat] = (y.detach(), grads, torch.rand(4, generator=gen))
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    torch.testing.assert_close(out[True][2], out[False][2], atol=0, rtol=0)
