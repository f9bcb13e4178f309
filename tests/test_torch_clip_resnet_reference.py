"""The port's ModifiedResNet CLIP tower against the benchmark's plain reference, and what the RN50x64 cell
rests on, at a small size with RN50x64's block pattern on the CPU.

- The tower (4 stages, blocks (1, 2, 3, 1), the stride pattern, a shortcut convolution in each stage's first
  block, the attention pool) at width 8 and 64 px, with weights drawn as the cell draws them (BatchNorm's
  statistics included), gives the reference's features and rewards within float32's rounding: both run the
  same convolutions; BatchNorm (``F.batch_norm`` against the written-out formula) and the attention pool
  (einsum against matmuls) round apart, about 1e-7 of the features' scale, so 1e-5 of it; a reward is
  exp(logit_scale) = 100 times a cosine, so its bound is 100 times a cosine's 1e-6.
- A float32 tower's convolutions run in IEEE float32 while the process allows TF32 in cuDNN's convolutions
  (PyTorch's default), and the flag reads as before afterwards; a bfloat16 tower's see the process's setting.
  Two float32 engines labeling at once in two threads keep it too.
- The weight draw: convolution kernels by fan-in, BatchNorm's scales, shifts and statistics drawn.
- The engine's ``tower_seconds`` counts each chunk's tower call.
- The RN50x64 cell at tiny widths: a sound run is correct; an answer altered and a call's frames answered in
  another order are not.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from arp_tpu_torch.models.clip.model import CLIP
from arp_tpu_torch.reward.engine import ClipRewardEngine
from portbench import run, weights_resnet
from portbench.reference import clip_resnet as ref_rn
from portbench.reference import tokenizer as ref_tokenizer

SMALL = dict(vocab_size=600, embed_dim=32, text_features=32, text_num_layers=2, text_num_heads=2,
             vision_features=8, vision_num_layers=(1, 2, 3, 1))
IMG = 64
FEATURE_RTOL = 1e-5
REWARD_ATOL = 100 * 1e-6


def small_model(seed: int = 5, dtype=torch.float32):
    model = CLIP(**SMALL, image_size=IMG)
    state = weights_resnet.fill(model, seed, "cpu")
    return model.eval().to(dtype), state


def frames(n: int, side: int = 40, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(n, side, side, 3), dtype=np.uint8)


@torch.no_grad()
def test_tower_features_match_the_reference():
    model, state = small_model()
    x = ref_rn.preprocess(torch.from_numpy(frames(6)), IMG)
    got = model.visual(x)[0]
    want = ref_rn.image_features(state, x, SMALL["vision_num_layers"], SMALL["vision_features"])
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= FEATURE_RTOL * scale


def test_engine_rewards_match_the_reference():
    """The labeler's call (Pillow-exact upsampling to 64 px on the device, two chunks, the last at its own
    size) against the reference's rewards; the rewards spread across frames far beyond the bound."""
    model, state = small_model()
    engine = ClipRewardEngine(model=model, batch_size=4, resize_mode="pil", device="cpu")
    text = "collect the coin"
    clip_tokens = np.asarray(engine.tokenize(text))
    ref_tokens = ref_tokenizer.tokenize(text)
    np.testing.assert_array_equal(clip_tokens, ref_tokens)
    got = engine.text_rewards_with_features(frames(7), engine.encode_text_features(text))
    with torch.no_grad():
        want = ref_rn.text_rewards(state, dict(SMALL, image_size=IMG), torch.from_numpy(frames(7)),
                                   torch.from_numpy(ref_tokens))
    np.testing.assert_allclose(got, want, rtol=0, atol=REWARD_ATOL)
    assert np.ptp(want) > 100 * REWARD_ATOL


@pytest.mark.parametrize("dtype,inside", [(torch.float32, "ieee"), (torch.bfloat16, "tf32")])
def test_float32_tower_convolves_without_tf32_whatever_the_flag(dtype, inside, monkeypatch):
    """cuDNN's convolutions consult the precision of ``torch.backends.cudnn.conv`` (which the legacy
    ``allow_tf32`` flag writes): every convolution of a float32 tower sees "ieee" while the process allows
    TF32; a bfloat16 tower's see the process's "tf32"."""
    model, _ = small_model(dtype=dtype)
    seen, real = [], F.conv2d

    def recording(*args, **kwargs):
        seen.append(torch.backends.cudnn.conv.fp32_precision)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", recording)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            model.encode_image(torch.zeros(2, IMG, IMG, 3, dtype=dtype))
        assert torch.backends.cudnn.allow_tf32 is True and torch.backends.cudnn.conv.fp32_precision == "tf32"
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert len(seen) == 3 + 3 * 7 + 4 and set(seen) == {inside}


def test_two_engines_in_two_threads_keep_the_guard(monkeypatch):
    """Two float32 towers labeling at once in two threads: every convolution of both sees "ieee", and the
    process's "tf32" is back after both (each forward restores its own setting, not the other's)."""
    seen, real = [], F.conv2d

    def slow(*args, **kwargs):
        seen.append(torch.backends.cudnn.conv.fp32_precision)
        time.sleep(2e-3)  # a convolution long enough for the other thread's forward to start inside it
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", slow)
    engines = [ClipRewardEngine(model=small_model()[0], batch_size=2, resize_mode="pil", device="cpu")
               for _ in range(2)]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        threads = [threading.Thread(target=e.encode_image_features, args=(frames(4),)) for e in engines]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cudnn.conv.fp32_precision == "tf32" and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert all(e.batches == 2 for e in engines)
    assert len(seen) == 4 * (3 + 3 * 7 + 4) and set(seen) == {"ieee"}


def test_weight_draw_by_fan_in_with_batch_norm_statistics():
    model = CLIP(**dict(SMALL, vision_features=32), image_size=IMG)
    state = weights_resnet.fill(model, 11, "cpu")
    again = weights_resnet.fill(CLIP(**dict(SMALL, vision_features=32), image_size=IMG), 11, "cpu")
    assert set(state) == set(model.state_dict()) and all(torch.equal(state[k], again[k]) for k in state)
    convs = {k: v for k, v in state.items() if v.ndim == 4 and v.numel() >= 16384}
    assert len(convs) >= 8
    for name, w in convs.items():
        assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.05, name
    bn = [k.rpartition(".")[0] for k in state if k.endswith("running_var")]
    assert len(bn) == 3 + 3 * 7 + 4
    for m in bn:
        assert (state[f"{m}.running_var"] >= 1).all() and float(state[f"{m}.running_var"].max()) > 1
        assert float(state[f"{m}.running_mean"].abs().max()) > 0
        assert abs(float(state[f"{m}.weight"].mean()) - 1) < 0.02 and abs(float(state[f"{m}.bias"].mean())) < 0.02
    assert float(state["logit_scale"]) == pytest.approx(np.log(100.0))


def test_tower_seconds_counts_every_chunk():
    model, _ = small_model()
    engine = ClipRewardEngine(model=model, batch_size=3, resize_mode="pil", device="cpu")
    start = time.perf_counter()
    engine.encode_image_features(frames(7))
    wall = time.perf_counter() - start
    assert engine.batches == 3 and 0 < engine.tower_seconds <= wall and engine._tower_times == []


TINY_CELL = (dict(SMALL, vision_num_layers=[1, 2, 3, 1], image_size=IMG),
             dict(batch_size=8, frames_per_call=12, frame_size=40, episodes=2))


@pytest.fixture
def process_tf32_flags():
    """The harness sets both TF32 flags for its process: put them back for the tests after this one."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("fault", [None, "answer_altered", "frames_shuffled"])
def test_rn_label_cell_is_correct_only_when_sound(fault, process_tf32_flags):
    over, params = TINY_CELL
    result = run.run_cell("label.rn50x64.f32", 2 ** 31 + 17, 0.2, False, device="cpu", config_over=over,
                          params_over=params, fault=fault)
    assert result["attempted"] >= 1 and result["correct"] == (fault is None), result["checks"]
    assert set(result["metrics"]) == {"label_frames_per_s", "setup_s"}
