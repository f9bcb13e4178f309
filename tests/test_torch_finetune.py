"""The port's ARP-DT+ adapter (arp_tpu_torch/finetune) against arp_tpu/finetune on the same weights.

The tiny CLIP of tests/test_finetune.py on both sides (vision 3 blocks, text 2: the vision tower
is deeper on purpose, so that reading only text_num_layers vision intermediates is a difference a
test can see), its TinyAdapter's widths (hidden 16), weights carried across by the bridges
(``flax_to_torch``, ``flax_adapter_to_torch``), inputs from numpy seeds.  Tolerances: 1e-5 on
float32 values computed in the same order (the resize's and the towers' sums run in other
orders); gradients 1e-4 of the largest entry; one AdamW step 1e-6.  The training forward replays
JAX's own key splits into the port's augmentation draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arp_tpu.finetune.decoder import LatentImageDecoder as JDecoder
from arp_tpu.finetune.decoder import reconstruction_loss as j_reconstruction_loss
from arp_tpu.models.clip import CLIP as JCLIP
from arp_tpu.ops.preprocess import clip_preprocess as j_clip_preprocess
from arp_tpu_torch.finetune.adapter_model import JITTER, ClipMultiscaleAdapter
from arp_tpu_torch.finetune.convert import flax_adapter_to_torch, flax_decoder_to_torch
from arp_tpu_torch.finetune.decoder import LatentImageDecoder, reconstruction_loss
from arp_tpu_torch.models.clip import CLIP, flax_to_torch
from arp_tpu_torch.ops.preprocess import clip_preprocess
from arp_tpu_torch.train.common import AdamW
from test_finetune import TINY_CFG, TinyAdapter, make_batch, tiny_tokens

ATOL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's adapter_setup of tests/test_finetune.py, and the port's modules on the same weights."""
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(1, 224, 224, 3)).astype(np.float32))
    clip_vars = JCLIP(**TINY_CFG).init(jax.random.PRNGKey(0), img, jnp.asarray(tiny_tokens(1)))
    model = TinyAdapter(action_dim=15)
    params = model.init({"params": jax.random.PRNGKey(1), "aug": jax.random.PRNGKey(2)}, clip_vars,
                        make_batch(rng), train=False)["params"]
    clip_np = jax.tree_util.tree_map(np.asarray, clip_vars)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    clip = CLIP(**TINY_CFG, image_size=224)
    clip.load_state_dict(flax_to_torch(clip_np))
    clip.eval()
    return model, clip_vars, params, clip, params_np


def port_adapter(params_np, **kwargs):
    adapter = ClipMultiscaleAdapter(clip_config=TINY_CFG, hidden_dim=16, **kwargs)
    adapter.load_state_dict(flax_adapter_to_torch(params_np))  # strict: every name and shape
    return adapter


def np_batch(seed, b=2, size=32):
    return jax.tree_util.tree_map(np.asarray, make_batch(np.random.default_rng(seed), b))


def t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, atol=ATOL):
    def host(x):
        return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.testing.assert_allclose(host(got), host(want), atol=atol, rtol=0)


# --- preprocessing -------------------------------------------------------------------------------


@pytest.mark.parametrize("mode,crop,shape", [
    ("fast", False, (3, 48, 40)), ("fast", True, (3, 64, 64)), ("pil", True, (3, 64, 48)), ("pil", False, (2, 32, 32)),
])
def test_clip_preprocess_matches_jax(mode, crop, shape):
    frames = np.random.default_rng(1).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    want = np.asarray(j_clip_preprocess(jnp.asarray(frames), image_size=24, resize_mode=mode, crop_half=crop))
    got = clip_preprocess(torch.from_numpy(frames), image_size=24, resize_mode=mode, crop_half=crop).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if mode == "pil":  # integer resize, then the same float32 arithmetic: bit for bit
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_clip_preprocess_refuses_host():
    with pytest.raises(ValueError, match="resize_mode"):
        clip_preprocess(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), image_size=4, resize_mode="host")


# --- the towers' intermediates and the encoders ---------------------------------------------------


def test_clip_intermediates_match_jax_capture(setup):
    _, clip_vars, _, clip, _ = setup
    rng = np.random.default_rng(2)
    img = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    tokens = tiny_tokens(3)
    tokens[1, 3:6] = [17, 40, 96]  # another length and EOT position
    jclip = JCLIP(**TINY_CFG)
    for method, x, tower, ours in (
        (jclip.encode_image, img, "visual", clip.encode_image(t(img), normalize=False, return_intermediates=True)),
        (jclip.encode_text, tokens, "text", clip.encode_text(t(tokens).long(), normalize=False,
                                                            return_intermediates=True)),
    ):
        final, state = jclip.apply(clip_vars, jnp.asarray(x), normalize=False, method=method,
                                   capture_intermediates=True, mutable=["intermediates"])
        inter = state["intermediates"][tower]["transformer"]
        got_final, got_inter = ours
        n_layers = TINY_CFG["vision_num_layers" if tower == "visual" else "text_num_layers"]
        assert len(got_inter) == n_layers == len([k for k in inter if k.startswith("intermediate_layer_")])
        for i in range(n_layers):
            _close(got_inter[i], inter[f"intermediate_layer_{i}"][0])
        _close(got_final, final)


@pytest.mark.parametrize("tokens_shape", [(2, 77), (2, 3, 77)], ids=["2d", "3d"])
def test_adapter_encoders_match_jax(setup, tokens_shape):
    model, clip_vars, params, clip, params_np = setup
    adapter = port_adapter(params_np)
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    want = model.apply({"params": params}, clip_vars, jnp.asarray(img), method=model.encode_image)
    _close(adapter.encode_image(clip, t(img)), want)
    tokens = tiny_tokens(int(np.prod(tokens_shape[:-1]))).reshape(tokens_shape)
    if len(tokens_shape) == 3:
        tokens[:, 1, 3] = 31  # the texts of a row differ
        tokens[:, 2, 1:4] = [7, 60, 96]
    want = model.apply({"params": params}, clip_vars, jnp.asarray(tokens), method=model.encode_text)
    got = adapter.encode_text(clip, t(tokens).long())
    assert got.shape == (2, want.shape[-1])
    _close(got, want)


def test_reference_quirks_are_kept(setup):
    """Each of the reference's quirks, on the port's side."""
    _, _, _, clip, params_np = setup
    adapter = port_adapter(params_np)
    L = TINY_CFG["text_num_layers"]
    # the vision intermediates are read to the text tower's depth, not the vision tower's
    assert adapter.num_clip_layers == L < TINY_CFG["vision_num_layers"]
    assert adapter.image_intermediate_linear.in_features == L * TINY_CFG["vision_features"]
    rng = np.random.default_rng(4)
    img = t(rng.normal(size=(2, 224, 224, 3)).astype(np.float32))
    before = adapter.encode_image(clip, img)
    with torch.no_grad():  # the last vision block is not read by the head: its CLS token enters only the final embedding
        final, inter = clip.encode_image(img, normalize=False, return_intermediates=True)
        cls = torch.cat([inter[i][:, 0] for i in range(L)], dim=-1)
        # the gate: res * feature + (1 - res) * adapter(feature), res = sigmoid(4)
        feature = torch.cat([adapter.image_intermediate_linear(cls), final], -1)
        res = torch.sigmoid(torch.tensor(4.0))
        gated = res * feature + (1 - res) * adapter.image_adapter(feature)
    assert adapter.image_residual_weight.item() == 4.0 == adapter.text_residual_weight.item()
    _close(before, gated / gated.norm(dim=-1, keepdim=True))
    assert adapter.lambda_id.item() == pytest.approx(np.log(1 / 0.07))
    # the ReLU after the inverse layer's last Linear: action logits are >= 0
    logits = adapter.inverse_layer(torch.randn(64, adapter.inverse_layer.Dense_0.in_features))
    assert float(logits.min()) >= 0.0 and float(logits.max()) > 0.0
    # the EOT token is the argmax of the ids, not the last token before the padding
    tokens = t(tiny_tokens(1)).long()
    tokens[0, 1:3] = torch.tensor([96, 5])

    def head(pos):
        with torch.no_grad():
            final, inter = clip.encode_text(tokens, normalize=False, return_intermediates=True)
            feature = torch.cat([adapter.text_intermediate_linear(torch.cat([inter[i][:, pos] for i in range(L)], -1)),
                                 final], -1)
            res = torch.sigmoid(adapter.text_residual_weight)
            gated = res * feature + (1 - res) * adapter.text_adapter(feature)
        return gated / gated.norm(dim=-1, keepdim=True)

    got = adapter.encode_text(clip, tokens)
    _close(got, head(1))
    assert not torch.allclose(got, head(2), atol=1e-4)
    # the loss: vip + lambda_id * id, lambda_id a raw multiplier
    batch = np_batch(5)
    loss, metrics = adapter(clip, batch, train=False)
    _close(loss, metrics["ob_vip_loss"] + adapter.lambda_id * metrics["ob_id_loss"], atol=1e-6)


# --- the loss, its gradients, one optimizer step -------------------------------------------------


def jax_draws(model, params, clip_vars, key) -> dict:
    """The augmentation JAX draws from ``key`` in ``model.apply(..., train=True, rngs={"aug": key})``, in the
    port's layout: the module's first make_rng("aug"), split into the 0.75 coin and the jitter key."""
    rng = model.bind({"params": params}, rngs={"aug": key}).make_rng("aug")
    apply_rng, jitter_rng = jax.random.split(rng)
    split = jax.random.split(jitter_rng, 4)
    jitter = {}
    for j, (field, amount) in enumerate(JITTER.items()):
        lo, hi = (-amount, amount) if field == "hue" else (max(0.0, 1 - amount), 1 + amount)
        jitter[field] = torch.tensor([float(jax.random.uniform(split[j], (), minval=lo, maxval=hi))])
    return {"apply": torch.tensor(bool(jax.random.uniform(apply_rng, ()) < 0.75)), "jitter": jitter}


@pytest.mark.parametrize("goal_conditioned", [False, True], ids=["text", "goal"])
def test_eval_forward_matches_jax(setup, goal_conditioned):
    model, clip_vars, params, clip, params_np = setup
    jmodel = TinyAdapter(action_dim=15, goal_conditioned=goal_conditioned)
    batch = np_batch(6, b=3)
    want_loss, want = jmodel.apply({"params": params}, clip_vars, batch, train=False)
    loss, got = port_adapter(params_np, goal_conditioned=goal_conditioned)(clip, batch, train=False)
    assert set(got) == set(want) == {"ob_id_acc", "ob_vip_loss", "ob_id_loss"}
    _close(loss, want_loss)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("key", [3, 11], ids=["key3", "key11"])
def test_train_forward_matches_jax_with_its_draws(setup, key):
    """train=True: the batch-shared color jitter, applied or not by the 0.75 coin, from JAX's keys."""
    model, clip_vars, params, clip, params_np = setup
    batch = np_batch(7)
    rngs = {"aug": jax.random.PRNGKey(key)}
    want_loss, want = model.apply({"params": params}, clip_vars, batch, train=True, rngs=rngs)
    draws = jax_draws(model, params, clip_vars, rngs["aug"])
    loss, got = port_adapter(params_np)(clip, batch, train=True, draws=draws)
    _close(loss, want_loss)
    for k in want:
        _close(got[k], want[k])
    plain, _ = port_adapter(params_np)(clip, batch, train=False)
    assert bool(draws["apply"]) == (abs(float(plain) - float(loss)) > 1e-6)  # the draws matter when applied


def test_train_draws_come_from_the_generator(setup):
    *_, clip, params_np = setup
    adapter = port_adapter(params_np)
    a = adapter.draw_preprocess(torch.Generator().manual_seed(5))
    b = adapter.draw_preprocess(torch.Generator().manual_seed(5))
    assert bool(a["apply"]) == bool(b["apply"]) and all(torch.equal(a["jitter"][k], b["jitter"][k]) for k in JITTER)
    coins = [bool(adapter.draw_preprocess(torch.Generator().manual_seed(s))["apply"]) for s in range(200)]
    assert 0.6 < np.mean(coins) < 0.9
    batch = np_batch(8)
    la, _ = adapter(clip, batch, train=True, generator=torch.Generator().manual_seed(9))
    lb, _ = adapter(clip, batch, train=True, generator=torch.Generator().manual_seed(9))
    assert float(la) == float(lb)


def test_gradients_match_jax_value_and_grad(setup):
    """The fine-tuning CLI's loss_fn (train=True): jax.value_and_grad against the port's autograd,
    every adapter parameter within 1e-4 of the largest entry; the frozen CLIP gets no gradient."""
    model, clip_vars, params, clip, params_np = setup
    batch = np_batch(9, b=3)
    key = jax.random.PRNGKey(4)

    def loss_fn(p):
        loss, _ = model.apply({"params": p}, clip_vars, batch, train=True, rngs={"aug": key})
        return loss

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    adapter = port_adapter(params_np)
    loss, _ = adapter(clip, batch, train=True, draws=jax_draws(model, params, clip_vars, key))
    loss.backward()
    _close(loss, want_loss)
    want = flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, want_grads))
    gmax = max(float(g.abs().max()) for g in want.values())
    for name, p in adapter.named_parameters():
        assert p.grad is not None, name
        err = float((p.grad - want[name]).abs().max()) / gmax
        assert err <= GRAD_REL, (name, err)
    assert all(p.grad is None for p in clip.parameters())


def test_one_adamw_step_matches_optax(setup):
    """``optax.adamw(1e-4, weight_decay=1e-4)``, the fine-tuning CLI's optimizer, on identical gradients."""
    model, clip_vars, params, clip, params_np = setup
    rng = np.random.default_rng(10)
    grads = jax.tree_util.tree_map(lambda p: rng.normal(size=np.shape(p)).astype(np.float32) * 1e-2, params_np)
    tx = optax.adamw(1e-4, weight_decay=1e-4)
    opt_state = tx.init(params)
    new_params = params
    for _ in range(2):
        updates, opt_state = tx.update(grads, opt_state, new_params)
        new_params = optax.apply_updates(new_params, updates)
    from arp_tpu_torch.finetune.train import build_optimizer

    adapter = port_adapter(params_np)
    opt = build_optimizer(adapter, 1e-4, 1e-4)
    assert isinstance(opt, AdamW) and opt.clip is None and all(opt.decay)
    names = [n for n, _ in adapter.named_parameters()]
    tgrads = flax_adapter_to_torch(grads)
    plist = [p for _, p in adapter.named_parameters()]
    state = opt.init(plist)
    for _ in range(2):
        state = opt.update(plist, [tgrads[n] for n in names], state)
    want = flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, new_params))
    for n, p in adapter.named_parameters():
        _close(p, want[n], atol=1e-6)


def test_tcn_term_matches_jax(setup):
    model, clip_vars, params, clip, params_np = setup
    batch = np_batch(11)
    want_loss, want = TinyAdapter(action_dim=15, use_tcn_loss=True).apply({"params": params}, clip_vars, batch,
                                                                        train=False)
    loss, got = port_adapter(params_np, use_tcn_loss=True)(clip, batch, train=False)
    _close(loss, want_loss)
    _close(got["ob_tcn_loss"], want["ob_tcn_loss"])


# --- the decoder ----------------------------------------------------------------------------------


@pytest.mark.parametrize("out_hw", [28, 20], ids=["exact", "resized"])
def test_latent_image_decoder_matches_jax(out_hw):
    """Transposed convolutions up from 7 x 7; at 20 the last doubling overshoots and a bilinear resize follows."""
    rng = np.random.default_rng(12)
    feats = rng.normal(size=(3, 24)).astype(np.float32)
    images = rng.uniform(size=(3, out_hw, out_hw, 3)).astype(np.float32)
    jdec = JDecoder(out_hw=out_hw, base_channels=32, start_hw=7)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"]
    want = np.asarray(jdec.apply({"params": params}, jnp.asarray(feats)))
    dec = LatentImageDecoder(24, out_hw=out_hw, base_channels=32, start_hw=7)
    dec.load_state_dict(flax_decoder_to_torch(jax.tree_util.tree_map(np.asarray, params)))
    got = dec(t(feats))
    assert got.shape == want.shape == (3, out_hw, out_hw, 3)
    _close(got, want)
    want_loss = j_reconstruction_loss(params, jdec, jnp.asarray(feats), jnp.asarray(images))
    _close(reconstruction_loss(dec, t(feats), t(images)), want_loss)
