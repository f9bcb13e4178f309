"""The port's ModifiedResNet CLIP towers against arp_tpu's, on the same weights.

At tests/test_clip_resnet.py's narrow config (width 8, one block a stage, 64 px)
with random BatchNorm statistics and scales: the image tower and both encoders
agree with the Flax ``CLIP`` within 1e-5; ``convert_torch_clip_vars`` maps an
OpenAI-layout ResNet state dict as the JAX converter does; the weight bridge
carries ``batch_stats`` both ways; the engines' float32 rewards agree within
1e-4 and bf16 within 0.05 x exp(logit_scale); engine specs cross between the
packages; ``fast`` / ``fast_int8`` fall to the standard path as in JAX; and every
published ResNet configuration builds with the Flax parameter shapes.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.models.clip import CLIP as FlaxCLIP
from arp_tpu.models.clip.convert import convert_torch_clip_vars as j_convert
from arp_tpu.models.clip.model import CONFIGS as FLAX_CONFIGS
from arp_tpu.models.clip.model import IMAGE_RESOLUTION as FLAX_RESOLUTION
from arp_tpu.models.clip.tokenizer import Char97Tokenizer as JChar97
from arp_tpu.reward.engine import ClipRewardEngine as JaxEngine
from arp_tpu_torch.models.clip import CLIP, CONFIGS, IMAGE_RESOLUTION, MODELS, convert_torch_clip_vars, flax_to_torch
from arp_tpu_torch.models.clip.convert import torch_to_flax
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward.engine import ClipRewardEngine
from tests.test_clip_resnet import CFG

IMG = 64
MAE = 1e-4
BF16_COS_MAE = 0.05
LOGIT_SCALE = float(np.log(100.0))


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _tokens(b, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((b, 77), np.int32)
    for i in range(b):
        n = int(rng.integers(1, 20))
        toks[i, 0] = 95
        toks[i, 1 : n + 1] = rng.integers(1, 95, size=n)
        toks[i, n + 1] = 96
    return toks


def _randomized(variables, seed):
    """The Flax init with every BatchNorm's statistics, scale and bias drawn, and logit_scale log(100)."""
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}

    def draw(tree, kind):
        for k, v in tree.items():
            if hasattr(v, "items"):
                draw(v, kind)
            elif kind == "stats":
                tree[k] = (rng.uniform(-0.5, 0.5, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)
                           ).astype(np.float32)
            elif k in ("scale", "bias") and v.ndim == 1:
                tree[k] = ((1.0 if k == "scale" else 0.0) + 0.2 * rng.normal(size=v.shape)).astype(np.float32)

    draw(variables["batch_stats"], "stats")
    draw(variables["params"]["visual"], "params")
    variables["params"]["logit_scale"] = np.asarray(LOGIT_SCALE, np.float32)
    return variables


@pytest.fixture(scope="module")
def flax_model_and_variables():
    model = FlaxCLIP(**CFG)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.normal(size=(1, IMG, IMG, 3)).astype(np.float32))
    variables = model.init(jax.random.PRNGKey(0), images, jnp.asarray(_tokens(1, 0)))
    return model, _randomized(variables, 1)


@pytest.fixture(scope="module")
def port_model(flax_model_and_variables):
    _, variables = flax_model_and_variables
    port = CLIP(**CFG, image_size=IMG).eval()
    port.load_state_dict(flax_to_torch(variables))  # strict: every parameter and statistic
    return port


def test_port_tower_has_the_flax_variables(flax_model_and_variables, port_model):
    _, variables = flax_model_and_variables
    assert port_model.is_resnet and port_model.vision_patch_size is None
    back = _leaves(torch_to_flax(port_model.state_dict()))
    want = _leaves(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg="/".join(k))


@pytest.mark.parametrize("normalize", [False, True])
def test_encoders_match_flax(flax_model_and_variables, port_model, normalize):
    model, variables = flax_model_and_variables
    rng = np.random.default_rng(2)
    images = rng.normal(size=(3, IMG, IMG, 3)).astype(np.float32)
    tokens = _tokens(3, 3)
    want_img = model.apply(variables, jnp.asarray(images), normalize=normalize, method=model.encode_image)
    want_txt = model.apply(variables, jnp.asarray(tokens), normalize=normalize, method=model.encode_text)
    with torch.no_grad():
        got_img = port_model.encode_image(torch.from_numpy(images), normalize=normalize)
        got_txt = port_model.encode_text(torch.from_numpy(tokens).long(), normalize=normalize)
    assert got_img.shape == (3, CFG["embed_dim"])
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-5)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), atol=1e-5)


def test_image_tower_and_feature_map_match_flax(flax_model_and_variables, port_model):
    """The tower's (pooled, feature map) pair, and ``vision_return_map``'s map, as the Flax tower's."""
    model, variables = flax_model_and_variables
    images = np.random.default_rng(4).normal(size=(2, IMG, IMG, 3)).astype(np.float32)

    def flax_visual(module, x):
        return module.visual(x)

    pooled, fmap = model.apply(variables, jnp.asarray(images), method=flax_visual)
    with torch.no_grad():
        got_pooled, got_map = port_model.visual(torch.from_numpy(images))
    assert got_map.shape == (2, IMG // 32, IMG // 32, 32 * CFG["vision_features"])
    np.testing.assert_allclose(got_pooled.numpy(), np.asarray(pooled), atol=1e-5)
    np.testing.assert_allclose(got_map.numpy(), np.asarray(fmap), atol=1e-5)

    map_model = FlaxCLIP(**CFG, vision_return_map=True)
    params = dict(variables["params"])
    params["visual"] = {k: v for k, v in params["visual"].items() if k != "attnpool"}
    map_vars = {"params": params, "batch_stats": variables["batch_stats"]}
    want = map_model.apply(map_vars, jnp.asarray(images), normalize=True, method=map_model.encode_image)
    port_map = CLIP(**CFG, image_size=IMG, vision_return_map=True).eval()
    port_map.load_state_dict(flax_to_torch(map_vars))
    with torch.no_grad():
        got = port_map.encode_image(torch.from_numpy(images), normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _openai_resnet_state_dict(seed):
    """An OpenAI-layout ResNet CLIP state dict of the narrow config, from tests/test_clip_resnet.py's replica."""
    from tests.test_clip import TorchTransformer
    from tests.test_clip_resnet import TorchModifiedResNet

    torch.manual_seed(seed)
    width = CFG["vision_features"]
    tmodel = TorchModifiedResNet(layers=CFG["vision_num_layers"], output_dim=CFG["embed_dim"],
                                 heads=width * 32 // 64, input_resolution=IMG, width=width).eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    sd = {"visual." + k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    ttext = TorchTransformer(CFG["text_features"], CFG["text_num_layers"], CFG["text_num_heads"])
    sd.update({"transformer." + k: v.detach().numpy() for k, v in ttext.state_dict().items()})
    rng = np.random.default_rng(seed)
    sd["token_embedding.weight"] = rng.normal(size=(97, 32)).astype(np.float32)
    sd["positional_embedding"] = 0.01 * rng.normal(size=(77, 32)).astype(np.float32)
    sd["ln_final.weight"] = np.ones(32, np.float32)
    sd["ln_final.bias"] = np.zeros(32, np.float32)
    sd["text_projection"] = rng.normal(size=(32, 32)).astype(np.float32)
    sd["logit_scale"] = np.float32(LOGIT_SCALE)
    sd["input_resolution"] = np.int64(IMG)
    return tmodel, sd


def test_convert_openai_resnet_state_dict_as_jax_does():
    tmodel, sd = _openai_resnet_state_dict(5)
    want = _leaves(jax.tree_util.tree_map(np.asarray, j_convert(sd)))
    got = _leaves(convert_torch_clip_vars(sd))
    assert got.keys() == want.keys() and ("batch_stats", "visual", "layer2.0", "downsample.1", "var") in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))
    # and the converted tower computes the OpenAI module's embedding
    port = CLIP(**CFG, image_size=IMG).eval()
    port.load_state_dict(flax_to_torch(convert_torch_clip_vars(sd)))
    images = np.random.default_rng(6).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    with torch.no_grad():
        want_emb = tmodel(torch.from_numpy(images.transpose(0, 3, 1, 2)))
        got_emb = port.encode_image(torch.from_numpy(images), normalize=False)
    np.testing.assert_allclose(got_emb.numpy(), want_emb.numpy(), atol=1e-5)


def test_weight_bridge_round_trips_batch_stats(flax_model_and_variables):
    _, variables = flax_model_and_variables
    flat = {"/".join(k): v for k, v in _leaves(variables).items()}  # save_npz's flattened keys
    nested, flattened = flax_to_torch(variables), flax_to_torch(flat)
    assert nested.keys() == flattened.keys()
    assert "visual.layer1.0.downsample.1.running_var" in nested and "visual.bn3.running_mean" in nested
    for k in nested:
        assert torch.equal(nested[k], flattened[k]), k
    np.testing.assert_array_equal(nested["visual.bn2.running_var"].numpy(),
                                  variables["batch_stats"]["visual"]["bn2"]["var"])
    np.testing.assert_array_equal(nested["visual.conv1.weight"].numpy(),
                                  variables["params"]["visual"]["conv1"]["kernel"].transpose(3, 2, 0, 1))
    back = _leaves(torch_to_flax(nested))
    assert back.keys() == _leaves(variables).keys()
    for k, v in _leaves(variables).items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(NotImplementedError):
        flax_to_torch({"batch_stats": {"visual": {"bn1": {"count": np.zeros(3)}}}})


def _engines(variables, **kw):
    kw.setdefault("batch_size", 8)
    jax_engine = JaxEngine(model=FlaxCLIP(**CFG), variables=variables, image_size=IMG, tokenizer=JChar97(), **{
        k: (jnp.bfloat16 if v is torch.bfloat16 else v) for k, v in kw.items()})
    port = ClipRewardEngine(model=CLIP(**CFG, image_size=IMG), variables=variables, tokenizer=Char97Tokenizer(),
                            device="cpu", **kw)
    return jax_engine, port


def _frames(seed, n, size=80):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("resize_mode,use_crop", [("pil", False), ("fast", False), ("pil", True), ("host", True)],
                         ids=["pil", "fast", "pil_crop", "host_crop"])
def test_float32_engine_rewards_match_jax(flax_model_and_variables, resize_mode, use_crop):
    _, variables = flax_model_and_variables
    jax_engine, port = _engines(variables, resize_mode=resize_mode, use_crop=use_crop)
    frames = _frames(7, 11)  # odd N: a padded last batch
    text = ["collect the coin.", "reach the saw."]
    got, want = port.text_rewards(frames, text), jax_engine.text_rewards(frames, text)
    assert got.shape == want.shape == (11,)
    assert np.abs(got - want).mean() <= MAE
    got_g, want_g = port.goal_rewards(frames), jax_engine.goal_rewards(frames)
    assert np.abs(got_g - want_g).mean() <= MAE
    assert port.encode_recipe.split(";", 1)[1] == jax_engine.encode_recipe.split(";", 1)[1]


def test_bf16_engine_within_the_jax_bf16_bound(flax_model_and_variables):
    """JAX's bf16 cast takes the ResNet's params and BatchNorm statistics; the text tower stays float32."""
    _, variables = flax_model_and_variables
    jax_engine, port = _engines(variables, compute_dtype=torch.bfloat16)
    assert port.model.visual.bn1.running_var.dtype == torch.bfloat16
    assert next(port.model.text.parameters()).dtype == torch.float32
    frames = _frames(8, 6)
    got, want = port.text_rewards(frames, "collect the coin."), jax_engine.text_rewards(frames, "collect the coin.")
    assert np.abs(got - want).mean() <= BF16_COS_MAE * np.exp(LOGIT_SCALE)


@pytest.mark.parametrize("knob", ["fast_encode", "fast_int8"])
def test_fast_paths_fall_to_the_standard_path_as_in_jax(flax_model_and_variables, knob):
    _, variables = flax_model_and_variables
    with pytest.warns(UserWarning, match="packed ViT pipeline"):
        jax_engine = JaxEngine(model=FlaxCLIP(**CFG), variables=variables, image_size=IMG, tokenizer=JChar97(),
                               batch_size=8, **{knob: True})
    with pytest.warns(UserWarning, match="packed ViT pipeline"):
        port = ClipRewardEngine(model=CLIP(**CFG, image_size=IMG), variables=variables, tokenizer=Char97Tokenizer(),
                                device="cpu", batch_size=8, **{knob: True})
    assert port._fast is None and not port._packed
    assert port.encode_recipe.split(";", 1)[1] == jax_engine.encode_recipe.split(";", 1)[1]
    frames = _frames(9, 5)
    assert np.abs(port.text_rewards(frames, "coin") - jax_engine.text_rewards(frames, "coin")).mean() <= MAE


def test_quantized_engine_quantizes_the_dense_kernels(flax_model_and_variables):
    """quantize_weights: every 2-D kernel of >= 1024 weights (the attention pool's and the text tower's), no
    convolution, as JAX's quantize_tree; the rewards stay within the JAX int8 engine's."""
    from arp_tpu_torch.ops.quantization import QuantLinear

    _, variables = flax_model_and_variables
    jax_engine, port = _engines(variables, quantize_weights=True)
    quantized = {n for n, m in port.model.named_modules() if isinstance(m, QuantLinear)}
    assert "visual.attnpool.key" in quantized and not any("conv" in n for n in quantized)
    frames = _frames(10, 4)
    assert np.abs(port.text_rewards(frames, "coin") - jax_engine.text_rewards(frames, "coin")).mean() <= MAE


def test_engine_specs_cross_between_the_packages(flax_model_and_variables, tmp_path):
    _, variables = flax_model_and_variables
    jax_engine, port = _engines(variables)
    frames = _frames(11, 5)
    jax_spec, port_spec = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_engine.save_npz(jax_spec)
    port.save_npz(port_spec)
    from_jax = ClipRewardEngine.from_npz(jax_spec, device="cpu", batch_size=8)
    from_port = JaxEngine.from_npz(port_spec, batch_size=8)
    assert from_jax.model.is_resnet and from_jax.image_size == IMG
    assert from_port.model.vision_num_layers == CFG["vision_num_layers"]
    want = jax_engine.text_rewards(frames, "coin")
    assert np.abs(from_jax.text_rewards(frames, "coin") - want).mean() <= MAE
    assert np.abs(from_port.text_rewards(frames, "coin") - want).mean() <= MAE
    with np.load(jax_spec) as a, np.load(port_spec) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a bf16 engine writes its float32 tower
    jax_bf16, port_bf16 = _engines(variables, compute_dtype=torch.bfloat16)
    port_bf16.save_npz(str(tmp_path / "bf16.npz"))
    with np.load(str(tmp_path / "bf16.npz")) as z:
        np.testing.assert_array_equal(z["batch_stats/visual/bn1/mean"], variables["batch_stats"]["visual"]["bn1"]["mean"])


@pytest.mark.parametrize("name", ["resnet_50", "resnet_101", "resnet_50x4", "resnet_50x16", "resnet_50x64"])
def test_every_resnet_config_builds_with_the_flax_shapes(name):
    """The published widths, built without memory (the meta device); the image tower's parameters and statistics
    against the Flax tower's init, shape for shape (the text tower is the ViT models', tests/test_torch_clip.py)."""
    from arp_tpu.models.clip.model import ModifiedResNet as FlaxModifiedResNet

    cfg = CONFIGS[name]
    assert cfg == FLAX_CONFIGS[name] and IMAGE_RESOLUTION[name] == FLAX_RESOLUTION[name]
    with torch.device("meta"):
        model = MODELS[name]()
    heads = cfg["vision_features"] * 32 // 64
    assert model.image_size == FLAX_RESOLUTION[name] and model.visual.attnpool.num_heads == heads
    size = FLAX_RESOLUTION[name]
    tower = FlaxModifiedResNet(features=cfg["vision_features"], out_features=cfg["embed_dim"],
                               num_layers=cfg["vision_num_layers"], num_heads=heads)
    shapes = jax.eval_shape(lambda: tower.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    want = {(k[0], "visual", *k[1:]): tuple(v.shape) for k, v in _leaves_shapes(shapes).items()}
    got = {}
    for key, value in model.state_dict().items():
        if key.startswith("visual."):
            got.update(_shape_of(key, value))
    assert got == want


def _leaves_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _shape_of(name, value):
    """The Flax path and shape of one state-dict entry, by torch_to_flax's rules (a meta tensor has no values)."""
    parts = []
    for part in name.split("."):
        if part.isdigit() and parts:
            parts[-1] = f"{parts[-1]}.{part}"
        else:
            parts.append(part)
    *mods, leaf = parts
    shape, collection = tuple(value.shape), "params"
    if leaf.startswith("running_"):
        collection, leaf = "batch_stats", leaf.removeprefix("running_")
    elif leaf == "weight":
        if len(shape) == 2:
            leaf, shape = ("embedding", shape) if mods[-1] == "token_embedding" else ("kernel", shape[::-1])
        elif len(shape) == 4:
            leaf, shape = "kernel", tuple(shape[i] for i in (2, 3, 1, 0))
        else:
            leaf = "scale"
    return {(collection, *mods, leaf): shape}


def test_vision_return_map_matches_flax_for_the_vit_too():
    """``vision_return_map`` on a ViT tower: every token's ln_post output, no projection, as the Flax tower."""
    from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE

    model = FlaxCLIP(**TINY_CLIP_CFG, vision_return_map=True)
    images = np.random.default_rng(12).normal(size=(2, TINY_CLIP_IMG_SIZE, TINY_CLIP_IMG_SIZE, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0), jnp.asarray(images),
                                                              jnp.asarray(_tokens(1, 0))))
    port = CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE, vision_return_map=True).eval()
    port.load_state_dict(flax_to_torch(variables))
    want = model.apply(variables, jnp.asarray(images), normalize=True, method=model.encode_image)
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(images), normalize=True)
    assert got.shape == (2, (TINY_CLIP_IMG_SIZE // 8) ** 2 + 1, TINY_CLIP_CFG["vision_features"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
