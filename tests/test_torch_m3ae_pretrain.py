"""M3AE pretraining in the port against the JAX package: the decoders' output head ``MLP``,
``random_masking`` on JAX's own uniform draw (bit-equal), the two losses, the M3AE and MAE
``__call__`` with the same masking draws fed to both sides, one whole pretraining step (loss,
gradients, params after clip + AdamW, the weight-decay mask on the Flax paths), and the port's
CLI run in-process on a tiny HDF5 file.  Narrow widths; float32 within 1e-5."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arp_tpu.models import layers as jlayers
from arp_tpu.models import m3ae as jm3ae
from arp_tpu_torch.models import layers as tlayers
from arp_tpu_torch.models import m3ae as tm3ae
from arp_tpu_torch.models.clip.convert import _flatten
from arp_tpu_torch.models.policy.convert import flax_m3ae_to_torch, flax_params_to_torch, flax_path, torch_policy_to_flax
from arp_tpu_torch.parallel.step import TrainState, make_train_step
from arp_tpu_torch.train import pretrain_m3ae as tpre
from arp_tpu_torch.train.common import warmup_cosine_decay_schedule

TOL = 1e-5
PATCH, IMG, FRAME = 8, 32, 48  # patches of 8 on 32 px frames, resized from 48 px (antialiased)
NPATCH, PATCH_DIM = (IMG // PATCH) ** 2, PATCH * PATCH * 3
VOCAB, TEXT = 97, 8
CFG = dict(model_type="custom", emb_dim=32, depth=2, num_heads=4, dec_emb_dim=16, dec_depth=1, dec_num_heads=2,
           mlp_ratio=2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(got, want, tol=TOL, scale=None):
    """``got`` within ``tol`` of ``want``: absolute where ``scale`` is given (tol * scale), else relative."""
    got, want = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got), np.asarray(want)
    if scale is None:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def perturbed(variables, seed):
    """Every leaf moved off its init value (zero biases and unit scales included)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                  jax.device_get(variables))


class FedJax:
    """The ``jax`` that arp_tpu.models.m3ae sees, with ``jax.random.uniform`` answering the given
    draws in turn: JAX's own ``random_masking`` then runs on them."""

    def __init__(self, draws):
        draws = iter(draws)
        self.random = types.SimpleNamespace(uniform=lambda rng, shape, dtype=None: jnp.asarray(next(draws)))

    def __getattr__(self, name):
        return getattr(jax, name)


def feed_draws(monkeypatch, draws):
    """Both packages' masking take ``draws`` (a list of (seq_len,) float32 arrays), in order."""
    monkeypatch.setattr(jm3ae, "jax", FedJax(list(draws)))
    port_draws = iter(list(draws))
    from_uniform = tm3ae.random_masking_from_uniform
    monkeypatch.setattr(tm3ae, "random_masking", lambda x, keep_len, padding_mask=None, generator=None: from_uniform(
        x, torch.from_numpy(next(port_draws)), keep_len, padding_mask))


# -- MLP -----------------------------------------------------------------------------------------

@pytest.mark.parametrize("depth,input_norm", [(0, False), (1, True), (2, True), (2, False)])
def test_mlp_matches_flax_and_maps_its_names_both_ways(depth, input_norm):
    x = np.random.default_rng(0).normal(size=(3, 5, 16)).astype(np.float32)
    jmlp = jlayers.MLP(16, 11, depth, input_norm=input_norm)
    params = perturbed(jmlp.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    tmlp = tlayers.MLP(16, 16, 11, depth, input_norm=input_norm)
    tmlp.load_state_dict(flax_params_to_torch(params))  # strict
    want = jmlp.apply(params, jnp.asarray(x))
    close(tmlp(torch.from_numpy(x)), want)
    back = torch_policy_to_flax(tmlp.state_dict())
    flat = _flatten(params["params"])
    assert set(_flatten(back)) == set(flat)
    for path, value in _flatten(back).items():
        np.testing.assert_array_equal(value, flat[path])


# -- masking and losses --------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len,keep,padded", [(16, 4, True), (256, 64, False), (64, 16, True)])
def test_random_masking_is_bit_equal_on_jax_s_uniform_draw(seq_len, keep, padded):
    rng = np.random.default_rng(seq_len)
    x = rng.normal(size=(3, seq_len, 5)).astype(np.float32)
    pad = (rng.random((3, seq_len)) < 0.3).astype(np.float32) if padded else None
    key = jax.random.PRNGKey(seq_len)
    uniform = np.asarray(jax.random.uniform(key, (seq_len,), dtype=jnp.float32))
    want = jm3ae.random_masking(jnp.asarray(x), key, keep, None if pad is None else jnp.asarray(pad))
    got = tm3ae.random_masking_from_uniform(torch.from_numpy(x), torch.from_numpy(uniform), keep,
                                            None if pad is None else torch.from_numpy(pad))
    assert len(got) == len(want) == (4 if padded else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the generator's wrapper draws one float32 uniform of seq_len from the generator it is given
    gen = torch.Generator().manual_seed(3)
    drawn = tm3ae.random_masking(torch.from_numpy(x), keep, generator=gen)
    again = tm3ae.random_masking_from_uniform(torch.from_numpy(x), torch.rand(seq_len, generator=torch.Generator().manual_seed(3)), keep)
    for g, w in zip(drawn, again):
        assert torch.equal(g, w)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 9, VOCAB)).astype(np.float32) * 3
    tokens = rng.integers(0, VOCAB, size=(4, 9)).astype(np.int32)
    tokens[0, :3] = logits[0, :3].argmax(-1)  # some hits
    valid = (rng.random((4, 9)) < 0.6).astype(np.float32)
    valid[1] = 0.0  # a sequence with nothing valid: its count is held at 1e-5
    for args in ((valid,), ()):
        want = jm3ae.cross_entropy_loss_and_accuracy(jnp.asarray(logits), jnp.asarray(tokens), *map(jnp.asarray, args))
        got = tm3ae.cross_entropy_loss_and_accuracy(torch.from_numpy(logits), torch.from_numpy(tokens),
                                                    *map(torch.from_numpy, args))
        for g, w in zip(got, want):
            close(g, w)
    out = rng.normal(size=(4, 16, 12)).astype(np.float32)
    target = rng.normal(size=(4, 16, 12)).astype(np.float32)
    mask = (rng.random((4, 16)) < 0.75).astype(np.float32)
    mask[:, 0] = 1.0
    for args in ((mask,), ()):
        close(tm3ae.patch_mse_loss(torch.from_numpy(out), torch.from_numpy(target), *map(torch.from_numpy, args)),
              jm3ae.patch_mse_loss(jnp.asarray(out), jnp.asarray(target), *map(jnp.asarray, args)))
    images = rng.normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    patches = tm3ae.extract_patches(torch.from_numpy(images), PATCH)
    np.testing.assert_array_equal(tm3ae.merge_patches(patches, PATCH).numpy(), images)
    np.testing.assert_array_equal(tm3ae.merge_patches(patches, PATCH).numpy(),
                                  np.asarray(jm3ae.merge_patches(jnp.asarray(patches.numpy()), PATCH)))


# -- the autoencoders ----------------------------------------------------------------------------

def inputs(seed=1, batch=3):
    rng = np.random.default_rng(seed)
    patch = rng.normal(size=(batch, NPATCH, PATCH_DIM)).astype(np.float32)
    ids = rng.integers(0, VOCAB, size=(batch, TEXT)).astype(np.int32)
    pad = np.zeros((batch, TEXT), np.float32)
    pad[:, 5:] = 1.0
    pad[0, :] = 1.0  # one row is padding throughout
    return patch, ids, pad


def draws(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.random(n, dtype=np.float32) for n in lengths]


def m3ae_pair(seed=0, **over):
    """A Flax M3AE initialised through ``__call__`` (decoder included), every leaf perturbed, and the
    port's autoencoder loaded strictly from it through the bridge."""
    cfg = dict(CFG, **over)
    patch, ids, pad = inputs()
    jmodel = jm3ae.MaskedMultimodalAutoencoder(config_updates=cfg, text_vocab_size=VOCAB, image_output_dim=PATCH_DIM)
    init = jax.jit(lambda rngs, *args: jmodel.init(rngs, *args, deterministic=True))
    variables = perturbed(init({"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(seed + 1)},
                               jnp.asarray(patch), jnp.asarray(ids), jnp.asarray(pad)), seed + 100)
    tmodel = tm3ae.MaskedMultimodalAutoencoder(cfg, text_vocab_size=VOCAB, image_output_dim=PATCH_DIM, decoder=True)
    tmodel.load_state_dict(flax_m3ae_to_torch(variables, decoder=True))  # strict: every name and shape
    return jmodel, variables, tmodel


@pytest.mark.parametrize("over", [{}, dict(output_head_depth=1, use_type_embedding=False)])
def test_m3ae_call_matches_flax_on_the_same_masking_draws(monkeypatch, over):
    jmodel, variables, tmodel = m3ae_pair(**over)
    patch, ids, pad = inputs(seed=2)
    feed_draws(monkeypatch, draws(5, NPATCH, TEXT) * 2)
    # jit: one trace, which takes the fed draws (a new function each time, so no stale trace)
    want = jax.jit(lambda v, *args: jmodel.apply(v, *args, deterministic=False, rngs={"noise": jax.random.PRNGKey(9)}))(
        variables, jnp.asarray(patch), jnp.asarray(ids), jnp.asarray(pad))
    got = tmodel(torch.from_numpy(patch), torch.from_numpy(ids).long(), torch.from_numpy(pad))
    assert [tuple(g.shape) for g in got] == [(3, NPATCH, PATCH_DIM), (3, TEXT, VOCAB), (3, NPATCH), (3, TEXT)]
    for g, w in zip(got, want):
        close(g, w)
    # the encoder alone (image only, text only) keeps Flax's token split
    for image, text in ((patch, None), (None, ids)):
        feed_draws(monkeypatch, draws(6, NPATCH if text is None else TEXT) * 2)
        want = jax.jit(lambda v, p: jmodel.apply(
            v, None if image is None else jnp.asarray(image), None if text is None else jnp.asarray(text), p,
            method=jmodel.forward_encoder, rngs={"noise": jax.random.PRNGKey(9)}))(variables, jnp.asarray(pad))
        got = tmodel.forward_encoder(None if image is None else torch.from_numpy(image),
                                     None if text is None else torch.from_numpy(text).long(), torch.from_numpy(pad))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                close(g, w)


def test_mae_call_matches_flax_on_the_same_masking_draws(monkeypatch):
    patch, _, _ = inputs()
    jmodel = jm3ae.MaskedAutoencoder(config_updates=CFG, image_output_dim=PATCH_DIM)
    variables = perturbed(jmodel.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                                      jnp.asarray(patch), deterministic=True), 7)
    tmodel = tm3ae.MaskedAutoencoder(CFG, image_output_dim=PATCH_DIM, decoder=True)
    tmodel.load_state_dict(flax_m3ae_to_torch(variables, decoder=True))
    feed_draws(monkeypatch, draws(8, NPATCH) * 2)
    want = jmodel.apply(variables, jnp.asarray(patch), deterministic=False, rngs={"noise": jax.random.PRNGKey(3)})
    got = tmodel(torch.from_numpy(patch))
    for g, w in zip(got, want):
        close(g, w)


def test_encoder_only_modules_keep_their_tree_and_load_strictly():
    """A module built as the policies build it holds no decoder: the full tree's encoder side loads
    strictly, its state dict has no decoder leaf, and the autoencoding forward refuses to run."""
    _, variables, full = m3ae_pair()
    enc = tm3ae.MaskedMultimodalAutoencoder(CFG, text_vocab_size=VOCAB, image_output_dim=PATCH_DIM)
    enc.load_state_dict(flax_m3ae_to_torch(variables))  # strict
    assert not any(k.startswith("decoder") or "mask_embedding" in k for k in enc.state_dict())
    assert set(enc.state_dict()) < set(full.state_dict())
    patch, ids, pad = (torch.from_numpy(x) for x in inputs())
    with pytest.raises(RuntimeError, match="decoder=True"):
        enc(patch, ids.long(), pad)
    torch.testing.assert_close(enc.forward_representation(patch, ids.long(), pad),
                               full.forward_representation(patch, ids.long(), pad), rtol=0, atol=0)
    # the port's full tree goes back to Flax's, leaf for leaf
    back, want = _flatten(torch_policy_to_flax(full.state_dict())), _flatten(variables["params"])
    assert set(back) == set(want)
    for path in want:
        np.testing.assert_array_equal(back[path], np.asarray(want[path], np.float32))


# -- one pretraining step ------------------------------------------------------------------------

def jax_decay_mask(model, params):
    """arp_tpu/train/pretrain_m3ae.py:103-111, as written there (a closure of its main)."""
    import flax

    no_decay = set(model.no_decay_list())
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(params))
    return flax.traverse_util.unflatten_dict({p: not any(nd in k for nd in no_decay for k in p) for p in flat})


def jax_loss_fn(model, image_size, patch_size):
    """arp_tpu/train/pretrain_m3ae.py:121-151, as written there (closures of its main)."""

    def prepare(batch):
        image = batch["image"].astype(jnp.float32) / 255.0
        if image.shape[1] != image_size:
            image = jax.image.resize(image, (image.shape[0], image_size, image_size, 3), "bilinear")
        return jm3ae.extract_patches(image, patch_size)

    def loss_fn(params, batch, rng):
        noise_rng, drop_rng = jax.random.split(rng)
        patches = prepare(batch)
        text = batch["text"].astype(jnp.int32)
        pad = batch["text_padding_mask"].astype(jnp.float32)
        image_out, text_out, image_mask, text_mask = model.apply(
            {"params": params}, patches, text, pad, deterministic=False,
            rngs={"noise": noise_rng, "drop_path": drop_rng})
        img_loss = jm3ae.patch_mse_loss(image_out, patches, image_mask)
        txt_loss, txt_acc = jm3ae.cross_entropy_loss_and_accuracy(text_out, text, (1.0 - pad) * text_mask)
        return img_loss + txt_loss, {"image_loss": img_loss, "text_loss": txt_loss, "text_acc": txt_acc}

    return loss_fn


def test_decay_mask_is_jax_s_leaf_for_leaf():
    jmodel, variables, tmodel = m3ae_pair()
    want = _flatten(jax_decay_mask(jmodel, variables["params"]))
    params = list(tmodel.named_parameters())
    got = dict(zip([n for n, _ in params], tpre.decay_mask(tmodel, params)))
    by_path = {flax_path(n, p.ndim): got[n] for n, p in params}
    assert by_path == want
    no_decay = sorted(n for n, d in got.items() if not d)
    assert no_decay == ["cls_token", "encoder_image_type_embedding", "encoder_text_type_embedding",
                        "image_mask_embedding", "text_embedding.weight", "text_mask_embedding"]
    # biases, LayerNorm scales and the decoder's type embeddings decay, as under JAX's substring rule
    assert got["decoder_image_type_embedding"] and got["decoder_text_type_embedding"]
    assert got["encoder.blocks_0.norm1.weight"] and got["decoder_input_projection.bias"]


def test_one_pretraining_step_matches_jax(monkeypatch):
    """JAX's loss through value_and_grad and its chain(clip_by_global_norm(1.0), adamw(mask=decay_mask)) on
    the warmup-cosine schedule, against the port's loss_fn, make_train_step and build_optimizer: the same
    params, batch (48 px frames resized to 32) and masking draws."""
    jmodel, variables, tmodel = m3ae_pair(seed=3)
    rng = np.random.default_rng(11)
    batch = {"image": rng.integers(0, 256, size=(4, FRAME, FRAME, 3), dtype=np.uint8),
             "text": np.tile(rng.integers(1, VOCAB, size=(1, TEXT)).astype(np.int32), (4, 1)),
             "text_padding_mask": np.tile((np.arange(TEXT) >= 6).astype(np.float32), (4, 1))}
    lr, wd, total = 1.5e-4, 0.05, 10
    # warmup 0: the first step's learning rate is the peak (a warmup from 0 would move nothing)
    jschedule = optax.warmup_cosine_decay_schedule(0.0, lr, 0, total)
    tschedule = warmup_cosine_decay_schedule(0.0, lr, 0, total)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(jschedule, weight_decay=wd, mask=lambda p: jax_decay_mask(jmodel, p)))
    feed_draws(monkeypatch, draws(4, NPATCH, TEXT) * 2)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jax_loss_fn(jmodel, IMG, PATCH), has_aux=True))(
        params, jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    state = TrainState.create(tmodel, tpre.build_optimizer(tmodel, tschedule, wd))
    step = make_train_step(tpre.make_loss_fn(IMG, PATCH), learning_rate_fn=tschedule)
    port_grads = {}
    for name, p in state.params:  # the gradients the update sees
        p.register_hook(lambda g, name=name: port_grads.__setitem__(name, g.detach().clone()))
    _, taux = step(state, tpre.batch_on(batch, "cpu"), torch.Generator().manual_seed(0))
    close(taux["loss"], loss)
    for key in ("image_loss", "text_loss", "text_acc"):
        close(taux[key], aux[key])
    assert taux["learning_rate"] == pytest.approx(float(jschedule(0)))
    jgrads = _flatten(host_tree(grads))
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    got = _flatten(torch_policy_to_flax(port_grads))
    assert set(got) == set(jgrads)
    for path, g in jgrads.items():
        close(got[path], g, scale=gmax)
    want = _flatten(host_tree(new_params))
    pmax = max(float(np.abs(p).max()) for p in want.values())
    after = _flatten(torch_policy_to_flax(dict(state.params)))
    for path, p in want.items():
        close(after[path], p, scale=pmax)


def host_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), jax.device_get(tree))


# -- the CLI -------------------------------------------------------------------------------------

def test_cli_pretrains_logs_and_checkpoints_in_process(tmp_path):
    from tests.test_trainer_e2e import DATASET, make_labeled_dataset

    root = str(tmp_path / "demos")
    make_labeled_dataset(root, n=16)
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "ckpt")
    tpre.main(["--device=cpu", "--epochs=2", "--batch_size=8", "--log_freq=1", "--lr=1e-3", f"--dataset_name={DATASET}",
               "--patch_size=8", "--image_size=32", "--text_length=16", f"--checkpoint_dir={ckpt}",
               "--model.model_type=custom", "--model.emb_dim=32", "--model.dec_emb_dim=16", "--model.depth=2",
               "--model.dec_depth=1", "--model.num_heads=4", "--model.dec_num_heads=4", "--model.mlp_ratio=2",
               f"--data.path={root}", "--data.image_size=32", "--data.num_frames=8", "--data.window_size=4",
               f"--logging.output_dir={out}"])
    records = [json.loads(line) for line in open(os.path.join(out, os.listdir(out)[0], "metrics.jsonl"))]
    steps = [r for r in records if "image_loss" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3] and [r["epoch"] for r in steps] == [0, 0, 1, 1]
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["text_acc"] <= 1.0 for r in steps)
    assert steps[0]["learning_rate"] == 0.0 and steps[1]["learning_rate"] > 0.0  # one warmup epoch of 2 steps
    from arp_tpu_torch.checkpoint import CheckpointManager, load_policy_state

    assert CheckpointManager(ckpt).steps() == [2, 4]
    state, meta = load_policy_state(ckpt)
    assert meta["step"] == 4 and meta["epoch"] == 1 and "decoder_text_output.Dense_0.weight" in state
    model = tm3ae.MaskedMultimodalAutoencoder(dict(CFG, dec_num_heads=4), text_vocab_size=tpre.BERT_VOCAB_SIZE,
                                              image_output_dim=PATCH_DIM, decoder=True)
    model.load_state_dict(state)  # strict


@pytest.mark.parametrize("flag", ["--mesh_dp=2", "--mesh_fsdp=4"])
def test_several_devices_raise(flag):
    """In one process, as JAX's mesh on one device (several processes: tests/test_torch_parallel_trainers.py)."""
    with pytest.raises(AssertionError, match="1 devices"):
        tpre.main([flag, "--device=cpu"])
