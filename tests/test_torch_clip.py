"""Port CLIP (arp_tpu_torch/models/clip) against the Flax CLIP on the same weights.

Flax ``CLIP.init`` -> ``flax_to_torch`` -> the port; ``encode_image`` and
``encode_text`` agree at atol 1e-5 in float32, on the tiny test config and at
ViT-B/16 widths with 2 layers per tower.  The copied tokenizer and
instruction lookups must give the originals' ids and strings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arp_tpu.data.instructions as jinstr
from arp_tpu.models.clip import CLIP as FlaxCLIP
from arp_tpu.models.clip.tokenizer import Char97Tokenizer as JChar97
from arp_tpu.models.clip.tokenizer import build_tokenizer as j_build_tokenizer
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE
from arp_tpu_torch.data import instructions as tinstr
from arp_tpu_torch.models.clip import CLIP, MODELS, Char97Tokenizer, build_tokenizer, flax_to_torch

VIT_B16_2L = dict(embed_dim=512, vocab_size=49408, vision_num_layers=2, vision_features=768,
                  vision_patch_size=16, text_features=512, text_num_heads=8, text_num_layers=2)


def _tokens(b, vocab, seed):
    """SOT, random ids, EOT (the highest id), zero padding at varied lengths."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(1, 20))
        toks[i, 0] = vocab - 2
        toks[i, 1 : n + 1] = rng.integers(1, vocab - 2, size=n)
        toks[i, n + 1] = vocab - 1
    return toks


def _flax_and_port(cfg, img_size, b, seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(b, img_size, img_size, 3)).astype(np.float32)
    tokens = _tokens(b, cfg["vocab_size"], seed)
    model = FlaxCLIP(**cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), jnp.asarray(images), jnp.asarray(tokens))
    )
    # Flax initializes these two to zeros; give every weight a value that matters
    params = variables["params"]
    params["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    params["text"]["positional_embedding"] = 0.01 * rng.normal(
        size=params["text"]["positional_embedding"].shape).astype(np.float32)
    port = CLIP(**cfg, image_size=img_size)
    port.load_state_dict(flax_to_torch(variables))
    return model, variables, port, images, tokens


@pytest.mark.parametrize("cfg,img_size,b", [(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 3), (VIT_B16_2L, 224, 2)],
                         ids=["tiny", "vit_b16_widths_2_layers"])
def test_encoders_match_flax(cfg, img_size, b):
    model, variables, port, images, tokens = _flax_and_port(cfg, img_size, b, seed=1)
    with torch.no_grad():
        for normalize in (True, False):
            want = model.apply(variables, jnp.asarray(images), normalize=normalize, method=model.encode_image)
            got = port.encode_image(torch.from_numpy(images), normalize=normalize)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
            want = model.apply(variables, jnp.asarray(tokens), normalize=normalize, method=model.encode_text)
            got = port.encode_text(torch.from_numpy(tokens).long(), normalize=normalize)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(port.logit_scale) == pytest.approx(np.log(100.0))


def test_image_tower_takes_packed_patches():
    """Patch vectors in (p_row, p_col, channel) order give the image's features."""
    _, _, port, images, _ = _flax_and_port(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 2, seed=2)
    p, s = TINY_CLIP_CFG["vision_patch_size"], TINY_CLIP_IMG_SIZE
    patches = images.reshape(2, s // p, p, s // p, p, 3).transpose(0, 1, 3, 2, 4, 5).reshape(2, -1, p * p * 3)
    with torch.no_grad():
        np.testing.assert_allclose(
            port.encode_image(torch.from_numpy(patches)).numpy(),
            port.encode_image(torch.from_numpy(images)).numpy(), atol=1e-6,
        )


def test_weight_bridge_reads_flattened_keys():
    _, variables, port, _, _ = _flax_and_port(TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, 1, seed=3)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                flat["/".join(prefix + [k])] = v

    walk(variables, [])
    nested, flattened = flax_to_torch(variables), flax_to_torch(flat)
    assert nested.keys() == flattened.keys() == port.state_dict().keys()
    for key in nested:
        torch.testing.assert_close(nested[key], flattened[key], rtol=0, atol=0)


def test_weight_bridge_refuses_resnet_state():
    with pytest.raises(NotImplementedError):
        flax_to_torch({"batch_stats": {"visual": {"bn1": {"mean": np.zeros(3)}}}})
    with pytest.raises(NotImplementedError):
        flax_to_torch({"params": {"visual": {"conv1": {"kernel": np.zeros((3, 3, 3, 8))}}}})
    with pytest.raises(NotImplementedError):
        CLIP(**{**VIT_B16_2L, "vision_num_layers": (3, 4, 6, 3)})


def test_vit_b16_heads_and_shapes():
    model = MODELS["vit_b16"]()
    assert model.image_size == 224
    assert model.visual.transformer.resblocks[0].attn.num_heads == 12
    assert model.text.transformer.resblocks[0].attn.num_heads == 8
    assert model.visual.positional_embedding.shape == (197, 768)
    assert len(model.visual.transformer.resblocks) == 12


@pytest.mark.parametrize("text", [
    "the goal is to collect the coin.", "navigate a maze to collect the yellow cheese.",
    "NeurIPS 2023 &amp; Ernest N. Morial's   hall_way!", "",
])
def test_tokenizer_matches_jax(text):
    got = build_tokenizer(truncate=True)
    want = j_build_tokenizer(truncate=True)
    np.testing.assert_array_equal(got(text), want(text))
    np.testing.assert_array_equal(got([text, "x " * 100]), want([text, "x " * 100]))
    assert got.tokenizer.identity == want.tokenizer.identity
    np.testing.assert_array_equal(Char97Tokenizer()(text), JChar97()(text))


def test_instruction_lookups_match_jax():
    for env in ("coinrun", "coinrun_aisc", "maze", "maze_aisc", "maze_yellowline",
                "maze_redline_yellowgem", "unknown"):
        assert tinstr.get_clip_instruct(env) == jinstr.get_clip_instruct(env)
        for inst in ("random1", "random2", "misinfo", "misinfo2", "misinfo3", "misinfo4", "bogus"):
            try:
                want = jinstr.get_clip_special_instruct(env, inst)
            except ValueError:
                with pytest.raises(ValueError):
                    tinstr.get_clip_special_instruct(env, inst)
            else:
                assert tinstr.get_clip_special_instruct(env, inst) == want
