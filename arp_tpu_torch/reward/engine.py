"""Batched CLIP reward engine on one GPU (port of arp_tpu/reward/engine.py).

Per device batch of uint8 frames (``batch_size`` rows, the last batch of a call
its own rows):

    packed (B, H, W*C) frames -> bit-exact Pillow resize, normalize, patchify
    -> ViT image tower (attention through kernel K1 on CUDA)
    -> L2-normalized or raw float32 features

A ModifiedResNet model (``resnet_50`` ... ``resnet_50x64``) takes (B, H, W, C)
images instead of patches, so it never takes the packed pipeline (which needs
``vision_patch_size``): its frames go through ``clip_preprocess`` and the CLIP
module, and ``fast_encode`` / ``fast_int8`` warn and fall to that standard
path, as in the JAX engine.  Its text tower's attention is K1's.

The image tower runs one of three ways, as in the JAX engine:

  * the CLIP module (the standard path), in ``compute_dtype``; with
    ``quantize_weights`` every large Linear of both towers holds int8 weights
    and multiplies through kernel K3 on CUDA (ops/quantization.py);
  * ``fast_encode``: the packed fused-QKV forward of ops/vit_infer.py in
    ``compute_dtype``;
  * ``fast_int8``: the packed static-int8 forward, calibrated lazily on the
    first device batch, every int8 matmul through kernel K2 on CUDA and,
    under ``fast_int8_attn``, w8a8 attention.

``tower_seconds`` counts the image tower's time over every chunk (the resize and
the copies left out): on CUDA from two timing events around each chunk's tower
call, read at the call's fetch, which already waits for the card.

A producer thread slices host chunks and pins them, so the HDF5 read
of the next batches overlaps the device's work on this one; each chunk goes
to the device with a ``non_blocking`` copy, and the device work is queued
without waiting.  Rewards are computed on the host in numpy, as in the JAX
engine:

  * text rewards: ``exp(logit_scale) * cos(f_img, f_text)``, the mean over
    texts when several are given;
  * goal-conditioned rewards: ``-||f_img - f_goal||_2`` on unnormalized features.

With ``compute_dtype=torch.bfloat16`` the image tower's weights and inputs are
cast to bf16; the text tower and ``logit_scale`` stay float32, as in the JAX
engine, which casts only inside its image-encode program.

Frames take the packed Pillow-exact path above when ``resize_mode`` is "pil"
and ``use_crop`` is off, or "host": there the producer thread crops (under
``use_crop``) and resizes each chunk on the host in C++
(:func:`arp_tpu_torch.ops.preprocess.resize_bicubic_pil_host`, the same bytes),
so only ``image_size``² pixels a frame cross to the card, which then
normalizes and patchifies.  Otherwise (``resize_mode="fast"``, or "pil" with
``use_crop``) they take :func:`arp_tpu_torch.ops.preprocess.clip_preprocess`
on (B, H, W, C), and the image tower runs the CLIP module: as in the JAX
engine, the packed ``fast_encode`` / ``fast_int8`` paths need the packed
preprocessing, and ask for them there warns and runs the standard path.  The
fine-tuned engine (finetune/reward.py) builds its packed trunk on the unpacked
preprocessing.

:meth:`ClipRewardEngine.save_npz` writes the engine's spec (config, tokenizer
tag, image size, float32 weights in the Flax layout) for both packages'
``from_npz``.  The TPU's 64-multiple batch guard is left out.

``mesh`` (parallel/mesh.py::mesh_from_count, ``--mesh_dp``) is JAX's
single-process data parallelism over local devices: the weights go once to each
device (the module or the packed trunk, and the int8 pack once calibrated);
each chunk's rows split into ``n`` contiguous shares (``torch.chunk``'s: a last
chunk that ``n`` does not divide gives shorter or fewer shares), share i encoded
on device i, the features gathered back in row order.  One host thread launches
every share before anything waits, so the devices overlap.  The
int8 calibration runs once, on the whole first chunk, as GSPMD's amax is the
global batch's, and the calibrated pack is copied to every device.
Without ``variables`` or ``model`` the engine reads the OpenAI checkpoint of
``model_name`` from a local file
(:func:`arp_tpu_torch.models.clip.load_model_vars`), as the JAX engine does.
"""

from __future__ import annotations

import contextlib
import copy
import json
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models.clip.convert import _flatten, flax_to_torch, read_engine_spec, torch_to_flax
from ..models.clip.model import CLIP, IMAGE_RESOLUTION, MODELS, CLIPAttention, load_model_vars
from ..models.clip.tokenizer import Char97Tokenizer, build_tokenizer
from ..models.m3ae import extract_patches
from ..ops import vit_infer
from ..ops.preprocess import (center_crop_np, clip_preprocess, clip_preprocess_packed_patches,
                              resize_bicubic_pil_host)
from ..ops.quantization import quantize_linears
from ..profiling import span

_DTYPES = (torch.float32, torch.bfloat16)


def _mesh_devices(mesh) -> list:
    """The ordered devices of a local-device mesh (parallel/mesh.py::LocalMesh)."""
    devices = getattr(mesh, "devices", None)
    if not isinstance(devices, (list, tuple)) or not devices:
        raise TypeError(f"mesh must be a local-device mesh (parallel/mesh.py::mesh_from_count), got {mesh!r}")
    return [torch.device(d) for d in devices]


def _tree_to(tree, device):
    """A dict / list / tuple tree of tensors on ``device`` (None stays None)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class ClipRewardEngine:
    """Streams uint8 frames through preprocess + encode on ``device``; scores on the host.

    Args:
      model_name: key into ``arp_tpu_torch.models.clip.MODELS`` (default CLIP
        ViT-B/16), used when ``model`` is None.
      variables: CLIP weights in ``arp_tpu``'s Flax layout (nested mappings or
        flattened ``"params/a/b"`` keys; see ``models/clip/convert.py``).
        None with a ``model``: the model's own weights; None without one:
        ``load_model_vars(model_name)``, a local OpenAI checkpoint.
      batch_size: the largest device batch: a call's frames run in chunks of this many rows, the last
        chunk at its own size.
      resize_mode: "pil" (Pillow's bicubic, bit for bit, on the device),
        "host" (the same bytes, resized on the host before the copy) or
        "fast" (the antialiased float bicubic).
      use_crop: center-crop each frame to half its side before the resize.
      compute_dtype: torch.float32 or torch.bfloat16 for the image tower.
      device: where the towers run, e.g. "cuda" or "cpu".  CUDA without a GPU
        raises.
      quantize_weights: int8 weight-only storage of every Linear with >= 1024
        weights, in both towers (not with a fast path).
      fast_encode / fast_int8: the packed forward, in ``compute_dtype`` /
        static int8 (bf16 pack).
      fast_score_bf16: attention scores and softmax in bf16 on the packed
        paths; None means True, the JAX engine's default.  K1's softmax is
        float32 whatever this says, so on CUDA it acts only under int8
        attention; ``encode_recipe`` names the softmax dtype that runs.
      fast_int8_attn: w8a8 attention under ``fast_int8``; None means True,
        the JAX engine's default.
      score_bf16: bf16 attention scores and softmax on the standard path
        (both CLIP towers), as the JAX engine's; inert under a fast path, and
        says so.  K1's softmax is float32 whatever this says: it acts on the
        CPU, and the recipe names what was asked, as the JAX engine's does.
      image_size: the frames' resized side; None: the model's own, which is
        ``IMAGE_RESOLUTION[model_name]`` for a model built from its name.
    """

    def __init__(
        self,
        model_name: str = "vit_b16",
        variables=None,
        batch_size: int = 256,
        resize_mode: str = "pil",
        use_crop: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        tokenizer=None,
        model: Optional[CLIP] = None,
        device: Union[str, torch.device] = "cuda",
        quantize_weights: bool = False,
        fast_encode: bool = False,
        fast_int8: bool = False,
        fast_score_bf16: Optional[bool] = None,
        fast_int8_attn: Optional[bool] = None,
        score_bf16: bool = False,
        image_size: Optional[int] = None,
        mesh=None,
    ):
        if resize_mode not in ("pil", "fast", "host"):
            raise ValueError(f"resize_mode must be 'pil', 'fast' or 'host', got {resize_mode!r}")
        if mesh is not None:
            device = _mesh_devices(mesh)[0]  # the first share's device holds the engine's own modules
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {_DTYPES}, got {compute_dtype}")
        fast = bool(fast_encode or fast_int8)
        if quantize_weights and fast:
            raise ValueError("fast_encode/fast_int8 and quantize_weights are mutually exclusive: "
                             "the fast path repacks the float weights (int8 mode quantizes them itself)")
        self.device = resolve_device(device)
        if variables is None and model is None:
            variables = load_model_vars(model_name)
        if score_bf16 and fast:
            warnings.warn(
                "score_bf16 only affects the standard encode path and is inert under fast_encode/fast_int8 "
                "— use fast_score_bf16 for the packed paths",
                stacklevel=2,
            )
        if model is None:
            model = MODELS[model_name]()
            image_size = image_size or IMAGE_RESOLUTION.get(model_name, 224)
        if score_bf16:
            for module in model.modules():
                if isinstance(module, CLIPAttention):
                    module.score_dtype = torch.bfloat16
        if variables is not None:
            model.load_state_dict(flax_to_torch(variables))
        if quantize_weights:
            quantize_linears(model)
        model.eval().to(self.device)
        self.model = model
        self._quantized = quantize_weights
        self.resize_mode, self.use_crop = resize_mode, use_crop
        # the packed Pillow-exact preprocessing, which the packed encode paths need; "host" keeps it
        # under use_crop, since the host crops before it resizes
        self._host_resize = resize_mode == "host"
        self._packed = ((resize_mode == "pil" and not use_crop) or self._host_resize) and (
            model.vision_patch_size is not None)
        self._fast = self._fast_q = None
        self._fast_int8 = False
        if fast and self._packed:
            # from the float32 tower, cast once; the int8 pack is bf16 until calibrated
            self._init_packed_trunk(torch.bfloat16 if fast_int8 else compute_dtype, fast_int8, fast_score_bf16,
                                    fast_int8_attn)
        elif fast:
            warnings.warn(
                "fast_encode requires the packed ViT pipeline (ViT tower + pil/host resize, no engine-side crop); "
                "using the standard path", stacklevel=2)
        # the float32 image tower as save_npz writes it, kept on the host where the card's is cast
        self._visual_f32 = None
        if compute_dtype != torch.float32:
            self._visual_f32 = {k: v.detach().to("cpu", copy=True) for k, v in model.visual.state_dict().items()}
        model.visual.to(compute_dtype)
        self.logit_scale = float(np.exp(model.logit_scale.item()))
        self.batch_size = batch_size
        # cumulative counts (the reward server's /v1/health): frames encoded, frames added as padding (none:
        # every batch runs at its own size), device batches, text encodes
        self.frames_real = self.frames_padded = self.batches = self.text_encodes = 0
        # the image tower's seconds over every chunk (_timed_tower), and a call's readings not yet added: a
        # list the mesh's replicas share, drained at the call's fetch
        self.tower_seconds = 0.0
        self._tower_times = []
        self.image_size = image_size or model.image_size
        self.compute_dtype = compute_dtype
        self._tokenizer = tokenizer
        # provenance stamped onto labeled datasets; "torch;" keeps port labels
        # apart from the JAX engine's
        dtype_name = str(compute_dtype).removeprefix("torch.")
        score_name = "bfloat16" if score_bf16 else "float32"
        self._recipe = (f"torch;{dtype_name};score={score_name};resize={resize_mode};crop={int(use_crop)}"
                        f";wq={int(quantize_weights)}")
        if self._fast is not None:
            self._recipe = f"torch;packed;{self._packed_recipe()};resize={resize_mode};crop={int(use_crop)}"
        self._init_mesh(mesh)

    # device-bound modules a replica copies to its device, besides the CLIP module and the packs
    _replicated_modules: tuple = ()

    def _init_mesh(self, mesh) -> None:
        """Data parallelism over ``mesh``'s devices (JAX's ``_init_mesh``): one replica of the engine a
        device, holding its own copy of the weights; a device named twice is one replica, used twice."""
        self.mesh, self._replicas = mesh, None
        if mesh is None:
            return
        devices = _mesh_devices(mesh)
        n_data = int(mesh.shape.get("dp", 1)) * int(mesh.shape.get("fsdp", 1))
        if self.batch_size % n_data:
            raise ValueError(f"batch_size={self.batch_size} must be divisible by the mesh data parallelism "
                             f"dp*fsdp={n_data}")
        by_device = {}
        for dev in devices:
            if dev not in by_device:
                by_device[dev] = self._replica(dev)
        self._replicas = [by_device[dev] for dev in devices]

    def _replica(self, device: torch.device) -> "ClipRewardEngine":
        """The engine with its modules and packs on ``device``: itself on its own device, else a shallow
        copy holding copies of them."""
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device, twin.mesh, twin._replicas = device, None, None
        twin.model = copy.deepcopy(self.model).to(device)
        twin._fast = _tree_to(self._fast, device)
        twin._fast_q = _tree_to(self._fast_q, device)
        for name in self._replicated_modules:
            setattr(twin, name, copy.deepcopy(getattr(self, name)).to(device))
        return twin

    def _encode_shares(self, chunk: torch.Tensor, normalize: bool) -> list:
        """One host chunk over the mesh: its rows in contiguous shares (``torch.chunk``'s: a chunk that the
        replicas do not divide gives a shorter last share, or fewer shares), share i encoded on replica i,
        every share launched before any waits; the features of each share, on its device."""
        if self._fast is not None and self._fast_int8 and self._fast_q is None:
            # calibrate on the whole first chunk (GSPMD's amax is the global batch's), then copy the pack
            x = self._patches(chunk.to(self.device, non_blocking=True))
            self._fast_q = vit_infer.quantize_packed(self._fast, vit_infer.calibrate_vit(self._fast, x, self._heads))
            for replica in self._replicas:
                if replica is not self:
                    replica._fast_q = _tree_to(self._fast_q, replica.device)
        shares = chunk.chunk(len(self._replicas))
        return [replica._encode_chunk(share.to(replica.device, non_blocking=True), normalize)
                for replica, share in zip(self._replicas, shares)]

    def _init_packed_trunk(self, dtype: torch.dtype, fast_int8: bool, fast_score_bf16: Optional[bool],
                           fast_int8_attn: Optional[bool]) -> None:
        """The packed tower (ops/vit_infer.py) in ``dtype``, from the float32 module's weights;
        under ``fast_int8`` the bf16 pack, quantized at the first device batch."""
        self._fast_dtype = dtype
        self._fast = vit_infer.pack_vit_params(self.model.visual, dtype=dtype)
        self._fast_int8 = bool(fast_int8)
        self._heads = self.model.vision_features // 64
        # None resolves as in the JAX engine, so each flag means the same in both packages
        self._score_dtype = torch.bfloat16 if fast_score_bf16 in (None, True) else torch.float32
        self._int8_attn = self._fast_int8 and fast_int8_attn in (None, True)

    def _packed_recipe(self) -> str:
        # the softmax that runs: K1's is float32 on CUDA, int8 attention's is score_dtype
        ran = self._score_dtype if self.device.type == "cpu" or self._int8_attn else torch.float32
        dtype_name = "int8" if self._fast_int8 else str(self._fast_dtype).removeprefix("torch.")
        return f"{dtype_name};score={str(ran).removeprefix('torch.')};int8_attn={int(self._int8_attn)}"

    # the CLIP constructor fields a spec records, in the JAX engine's order
    _SPEC_FIELDS = ("vocab_size", "embed_dim", "text_features", "text_num_layers", "text_num_heads",
                    "vision_features", "vision_num_layers", "vision_patch_size")

    @classmethod
    def from_npz(cls, path: str, **engine_kwargs):
        """Rebuild an engine from a ``ClipRewardEngine.save_npz`` spec (either package's).

        ``engine_kwargs`` set runtime knobs (batch_size, compute_dtype,
        device, ...); the model config, weights, tokenizer and image size come
        from the file.
        """
        meta, flat = read_engine_spec(path)
        cfg = dict(meta["clip_config"])
        if isinstance(cfg["vision_num_layers"], list):
            cfg["vision_num_layers"] = tuple(cfg["vision_num_layers"])
        tokenizer = Char97Tokenizer() if meta["tokenizer"] == "char97" else None
        # "bpe:<sha16>"/"fallback"/"custom": leave None -> the engine lazily
        # builds the standard BPE tokenizer (same vocab given the merges file)
        model = CLIP(**cfg, image_size=meta["image_size"])
        engine_kwargs.setdefault("image_size", meta["image_size"])
        return cls(model=model, variables=flat, tokenizer=tokenizer, **engine_kwargs)

    def save_npz(self, path: str) -> None:
        """Write a self-contained engine spec, as the JAX engine's ``save_npz`` does: the CLIP config
        (``_SPEC_FIELDS``), the tokenizer tag, the image size and the float32 variables in the Flax
        layout flattened by "/", read by :meth:`from_npz` of either package."""
        if self._quantized:
            raise ValueError("save_npz writes float weights: build the engine without quantize_weights")
        state = self.model.state_dict()
        if self._visual_f32 is not None:
            state.update({f"visual.{k}": v for k, v in self._visual_f32.items()})
        flat = {"/".join(k): v for k, v in _flatten(torch_to_flax(state)).items()}
        cfg = {k: self.model.config[k] for k in self._SPEC_FIELDS}
        if isinstance(cfg["vision_num_layers"], tuple):
            cfg["vision_num_layers"] = list(cfg["vision_num_layers"])
        meta = {"clip_config": cfg,
                "tokenizer": self.tokenizer_identity, "image_size": self.image_size}
        np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **flat)

    # -- tokenization ---------------------------------------------------------

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            self._tokenizer = build_tokenizer(truncate=True)
        return self._tokenizer

    def tokenize(self, text: Union[str, Sequence[str]]) -> np.ndarray:
        return np.asarray(self.tokenizer(text))

    @property
    def tokenizer_identity(self) -> str:
        """Provenance string for labeled outputs: "bpe:<sha16>" with the real
        merges file, "fallback" under the byte-level fallback vocab, "custom"
        for injected tokenizers without identity metadata."""
        tok = getattr(self.tokenizer, "tokenizer", None)
        return getattr(tok, "identity", None) or "custom"

    @property
    def encode_recipe(self) -> str:
        """Provenance string for the numeric path that produces rewards."""
        return self._recipe

    # -- feature extraction ---------------------------------------------------

    def _patches(self, frames: torch.Tensor) -> torch.Tensor:
        """One device batch of packed uint8 frames (B, H, W*C) -> normalized ViT patches (B, N, P*P*C),
        or for a ResNet tower the normalized images (B, image_size, image_size, C)."""
        p = self.model.vision_patch_size
        if self._packed:
            return clip_preprocess_packed_patches(frames, channels=3, image_size=self.image_size, patch_size=p)
        b, h, wc = frames.shape
        # "host" frames arrive cropped and resized: only normalized here
        x = clip_preprocess(frames.reshape(b, h, wc // 3, 3), image_size=self.image_size,
                            resize_mode="pil" if self._host_resize else self.resize_mode,
                            crop_half=self.use_crop and not self._host_resize)
        return x if p is None else extract_patches(x, p)

    def _packed_trunk(self, x: torch.Tensor, return_intermediates: bool = False):
        """The packed tower on patches: float32 (B, embed_dim) features and, when asked, the
        per-layer CLS tokens (L, B, D).  The int8 pack calibrates on the first batch, as in JAX."""
        if not self._fast_int8:
            return vit_infer.vit_encode(self._fast, x, self._heads, compute_dtype=self._fast_dtype,
                                        score_dtype=self._score_dtype, return_intermediates=return_intermediates)
        if self._fast_q is None:
            amax = vit_infer.calibrate_vit(self._fast, x, self._heads)
            self._fast_q = vit_infer.quantize_packed(self._fast, amax)
        return vit_infer.vit_encode_int8(self._fast_q, x, self._heads, score_dtype=self._score_dtype,
                                         return_intermediates=return_intermediates, int8_attn=self._int8_attn)

    @contextlib.contextmanager
    def _timed_tower(self):
        """Around one chunk's image-tower call: its time, added to ``tower_seconds`` at the call's fetch.  On
        the card two CUDA timing events on the tower's stream, read once the fetch has waited for them (they add
        no synchronise); on the CPU, which computes as it goes, the host's clock."""
        if self.device.type != "cuda":
            start = time.perf_counter()
            yield
            self._tower_times.append(time.perf_counter() - start)
            return
        stream = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        self._tower_times.append((start, end))

    def _add_tower_times(self) -> None:
        """Add the readings of ``_timed_tower`` to ``tower_seconds``; after the fetch, so every event is done."""
        for t in self._tower_times:
            self.tower_seconds += t if isinstance(t, float) else t[0].elapsed_time(t[1]) / 1e3
        self._tower_times.clear()

    @torch.inference_mode()
    def _encode_chunk(self, frames: torch.Tensor, normalize: bool) -> torch.Tensor:
        """One device batch of packed uint8 frames (B, H, W*C) -> float32 features."""
        x = self._patches(frames)
        with self._timed_tower():
            if self._fast is None:
                feat = self.model.encode_image(x.to(self.compute_dtype), normalize=False).float()
            else:
                feat = self._packed_trunk(x)
        if normalize:
            feat = feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
        return feat

    def _batched_image_features(self, frames, normalize: bool) -> np.ndarray:
        """Encode (N, H, W, C) uint8 frames in device batches of at most ``batch_size`` rows.

        Every chunk but the last holds ``batch_size`` rows; the last runs at its own size, unpadded.
        ``frames`` is anything that slices like an array (an ndarray, or the labeler's lazy HDF5 window).
        A producer thread slices and (``resize_mode="host"``) crops and resizes the next chunks while the
        device works on this one.
        """
        n = frames.shape[0]
        if n == 0:
            raise ValueError("no frames to encode")
        bs = self.batch_size
        pin = self.device.type == "cuda"
        starts = list(range(0, n, bs))
        self.frames_real += n
        self.batches += len(starts)

        def host_stage(start: int, parent) -> torch.Tensor:
            with span("engine.host_stage", parent=parent):
                chunk = np.asarray(frames[start : start + bs])
                if self._host_resize:
                    if self.use_crop:
                        chunk = center_crop_np(chunk, chunk.shape[1] // 2, chunk.shape[2] // 2)
                    if chunk.shape[1:3] != (self.image_size, self.image_size):
                        chunk = resize_bicubic_pil_host(chunk, self.image_size, self.image_size)
                # (B, H, W, C) -> packed (B, H, W*C); a read-only buffer (a request's bytes) is copied
                chunk = np.require(chunk, requirements=("C", "W"))
                chunk = torch.from_numpy(chunk.reshape(chunk.shape[0], chunk.shape[1], -1))
                return chunk.pin_memory() if pin else chunk

        outputs = []
        with span("engine.images") as images:
            if images:
                images.set(frames=n, padded=0)
            with ThreadPoolExecutor(max_workers=1) as pool:
                pending = deque(pool.submit(host_stage, s, images) for s in starts[:2])
                for k in range(len(starts)):
                    if k + 2 < len(starts):
                        pending.append(pool.submit(host_stage, starts[k + 2], images))
                    with span("engine.host_wait"):
                        chunk = pending.popleft().result()
                    with span("engine.encode"):
                        if self._replicas is None:
                            outputs.append(self._encode_chunk(chunk.to(self.device, non_blocking=True), normalize))
                        else:
                            outputs.extend(self._encode_shares(chunk, normalize))
            # after the producer thread's join, which the device's queued work covers
            with span("engine.fetch"):
                if self._replicas is not None:  # the shares' features, from their devices, in row order
                    feats = torch.cat([o.to("cpu") for o in outputs]).numpy()
                else:
                    feats = torch.cat(outputs).cpu().numpy()
                self._add_tower_times()
                return feats

    def encode_image_features(self, frames, normalize: bool = True) -> np.ndarray:
        """Public batched image-feature extraction (streaming, in device batches of at most ``batch_size``)."""
        return self._batched_image_features(frames, normalize=normalize)

    @torch.inference_mode()
    def encode_text_features(self, text: Union[str, Sequence[str], np.ndarray]) -> np.ndarray:
        """L2-normalized float32 text features, (n_text, embed_dim)."""
        self.text_encodes += 1
        with span("engine.text"):
            tokens = self.tokenize(text) if isinstance(text, (str, list, tuple)) else np.asarray(text)
            tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
            return self._text_tower(tokens).float().cpu().numpy()

    def _text_tower(self, tokens: torch.Tensor) -> torch.Tensor:
        """(n_text, context) token ids on the device -> normalized text features."""
        return self.model.encode_text(tokens, normalize=True)

    # -- rewards --------------------------------------------------------------

    def text_rewards_with_features(self, frames, txt_feat: np.ndarray) -> np.ndarray:
        """Text rewards against precomputed (normalized) text features."""
        img_feat = self._batched_image_features(frames, normalize=True)
        with span("engine.score"):
            logits_per_text = self.logit_scale * (txt_feat @ img_feat.T)  # (n_text, N)
            if logits_per_text.shape[0] > 1:
                return logits_per_text.mean(axis=0)
            return logits_per_text[0]

    def text_rewards(self, frames, text: Union[str, Sequence[str], np.ndarray]) -> np.ndarray:
        """logit_scale * cosine(image, text); averaged over multiple texts."""
        return self.text_rewards_with_features(frames, self.encode_text_features(text))

    def goal_rewards_with_features(self, frames, goal_feat: np.ndarray) -> np.ndarray:
        """-||f(img) - f(goal)||_2 against precomputed unnormalized goal
        features ((D,) shared or (N, D) per-frame)."""
        feats = self._batched_image_features(frames, normalize=False)
        with span("engine.score"):
            return -np.linalg.norm(feats - np.atleast_2d(goal_feat), axis=-1)

    def goal_rewards(self, frames, goal_index: int = -1) -> np.ndarray:
        """-||f(img) - f(goal)||_2 on unnormalized features; the goal is the
        frame at ``goal_index`` within ``frames``."""
        feats = self._batched_image_features(frames, normalize=False)
        with span("engine.score"):
            return -np.linalg.norm(feats - feats[goal_index][None], axis=-1)

    def goal_rewards_vs(self, frames, goal_frame: np.ndarray) -> np.ndarray:
        """Goal rewards against an explicit goal image."""
        goal = self._batched_image_features(goal_frame[None], normalize=False)[0]
        return self.goal_rewards_with_features(frames, goal)
