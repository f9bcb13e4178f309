"""Tensor and pipeline parallelism of the port (ROADMAP 12c) against the JAX package, on four gloo ranks.

One spawn of four ranks on the CPU for the module (tests/torch_parallel_workers.py) runs:

  * ``pipeline_apply`` against ``sequential_apply`` at (S, M) in (2, 4), (4, 4), (4, 8) (each data
    share pipelining its own rows), within 1e-5 of JAX's sequential result, gradients with it;
  * a depth-4 stack of real blocks pipelined in 4 stages (with and without remat) against JAX's
    ``PipelinedTransformer`` on its 4-device CPU mesh (1e-4) and the port's flat stack (gradients);
  * three clipped-SGD steps of tests/test_mesh_equivalence.py's vit_debug ARPDT at (dp 2, tp 2),
    (fsdp 2, tp 2), (dp 2, pp 2) and (fsdp 2, pp 2), each held against JAX's ``MeshConfig(dp=-1)`` run
    on its 8-device mesh at JAX's bounds (loss 1e-4, params 2e-4) and against the port's one-process
    run at 1e-5;
  * the same at (dp 2, tp 2) with dropout and attention dropout, against one process over the same two
    data shares (1e-5);
  * the qkv share of each tp rank (its own heads' q, k and v), and checkpoints written at tp and pp
    layouts restored in one process and at the other layout.

``stack_transformer_params`` / ``unstack_transformer_params`` are held bit for bit against JAX's here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from arp_tpu.models import layers as jlayers
from arp_tpu.parallel import pipeline as jpipe
from arp_tpu.parallel.mesh import MeshConfig as JMeshConfig
from arp_tpu_torch.models import layers as tlayers
from arp_tpu_torch.models.policy import convert
from arp_tpu_torch.parallel import mesh as tmesh
from test_mesh_equivalence import _setup, _train

JAX_LOSS, JAX_PARAMS, PORT = 1e-4, 2e-4, 1e-5  # JAX's mesh-equivalence bounds; the port's own
PIPE_ATOL, BLOCKS_ATOL = 1e-5, 1e-4  # tests/test_pipeline_parallel.py's
ADAM_ACROSS_LAYOUTS = 1e-4  # a tenth of the checkpoint test's AdamW lr


def _gelu_stage(params, x):
    import flax.linen as nn

    return nn.gelu(x @ params["w"] + params["b"])


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's runs: the mesh test's dp=-1 training, sequential stages, a pipelined stack."""
    _, state, batch, _ = _setup()
    params, loss = _train(JMeshConfig(dp=-1))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    stages = {}
    for S in (2, 4):
        w = (rng.normal(size=(S, 16, 16)) * 0.1).astype(np.float32)
        b = (rng.normal(size=(S, 16)) * 0.1).astype(np.float32)
        stages[S] = {"w": w, "b": b,
                     "want": np.asarray(jpipe.sequential_apply(_gelu_stage, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                                               jnp.asarray(x)))}
    # a depth-4 stack: the flat Transformer's weights, and JAX's PipelinedTransformer over 4 stages on them
    xb = np.random.default_rng(2).normal(size=(8, 6, 32)).astype(np.float32)
    flat = jlayers.Transformer(emb_dim=32, depth=4, num_heads=4, mlp_ratio=2)
    flat_params = jax.device_get(flat.init(jax.random.PRNGKey(0), jnp.asarray(xb), deterministic=True)["params"])
    pipe = jlayers.PipelinedTransformer(emb_dim=32, depth=4, num_heads=4, mlp_ratio=2, stages=4, microbatches=4,
                                        mesh=jpipe.create_pp_mesh(4))
    stacked = jlayers.stack_transformer_params(flat_params, 4)
    blocks_want = np.asarray(pipe.apply({"params": stacked}, jnp.asarray(xb), deterministic=True))
    return {"init": convert.flax_policy_to_torch(jax.device_get(state.params)), "batch": batch,
            "params": {k: v.numpy() for k, v in convert.flax_policy_to_torch(params).items()}, "loss": loss,
            "x": x, "stages": stages, "xb": xb, "flat_params": flat_params, "blocks_want": blocks_want,
            "blocks_state": {k: v.numpy() for k, v in convert.flax_params_to_torch(flat_params).items()}}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    payload = {"init": {k: v.numpy() for k, v in jax_side["init"].items()}, "batch": jax_side["batch"],
               "pipeline": {"x": jax_side["x"], **{S: {"w": p["w"], "b": p["b"]} for S, p in jax_side["stages"].items()}},
               "blocks": {"state": jax_side["blocks_state"], "x": jax_side["xb"]}}
    return W.spawn(["case_pipeline", "case_pipelined_blocks", "case_tp_pp_train", "case_tp_qkv_share",
                    "case_tp_pp_checkpoint"], payload, tmp_path_factory.mktemp("ranks"), world=4)


def _max_abs(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max()) for k in want)


# -- the pipeline --------------------------------------------------------------------------------------


@pytest.mark.parametrize("S,M", [(2, 4), (4, 4), (4, 8)])
def test_pipeline_matches_sequential(ranks, jax_side, S, M):
    """Every rank ends with its data share's outputs (the last stage's, broadcast over pp); the stage's
    parameter gradients and the input's are sequential autograd's."""
    want_all = jax_side["stages"][S]["want"]
    rows = 16 // (4 // S)
    for rank in ranks:
        got = rank["case_pipeline"][(S, M)]
        share = want_all[got["index"] * rows:(got["index"] + 1) * rows]
        np.testing.assert_allclose(got["got"], share, atol=PIPE_ATOL)
        np.testing.assert_allclose(got["got"], got["want"], atol=PIPE_ATOL)
        for key in ("grad_w", "grad_b", "grad_x"):
            np.testing.assert_allclose(*got[key], atol=PIPE_ATOL, rtol=1e-5)


def test_pipelined_blocks_match_jax_and_the_flat_stack(ranks, jax_side):
    for rank in ranks:
        got = rank["case_pipelined_blocks"]
        np.testing.assert_allclose(got["want"], jax_side["blocks_want"], atol=BLOCKS_ATOL)
        for remat in (False, True):
            np.testing.assert_allclose(got[remat]["got"], jax_side["blocks_want"], atol=BLOCKS_ATOL)
            np.testing.assert_allclose(got[remat]["grad_x"], got["flat_grad_x"], atol=1e-4, rtol=1e-5)
            assert _max_abs(got[remat]["grads"], got["flat_grads"]) < 1e-4
        np.testing.assert_array_equal(got[True]["got"], got[False]["got"])


def test_stack_and_unstack_are_jax_s_bit_for_bit(jax_side):
    flat = jax_side["flat_params"]
    for stages in (1, 2, 4):
        want = jax.device_get(jlayers.stack_transformer_params(flat, stages))
        got = tlayers.stack_transformer_params(flat, stages)
        assert _flat_equal(got, want)
        assert _flat_equal(tlayers.unstack_transformer_params(got), jax.device_get(jlayers.unstack_transformer_params(want)))
        assert _flat_equal(tlayers.unstack_transformer_params(got), flat)


def _flat_equal(a, b) -> bool:
    from arp_tpu_torch.models.clip.convert import _flatten

    fa, fb = _flatten(a), _flatten(b)
    return set(fa) == set(fb) and all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def test_a_stacked_policy_tree_converts_to_the_flat_names(jax_side):
    """JAX's pipelined policy holds policy/stacked_blocks; the bridge gives the flat stack's names."""
    params = jax.device_get(_setup()[1].params)
    stacked = dict(params, policy=jlayers.stack_transformer_params(params["policy"], 2))
    flat = convert.flax_policy_to_torch(params)
    got = convert.flax_policy_to_torch(stacked)
    assert set(got) == set(flat) and all(torch.equal(got[k], flat[k]) for k in flat)
    back = convert.torch_policy_to_flax(got, pp_stages=2)
    assert _flat_equal(back["policy"], jax.device_get(stacked["policy"]))


# -- tensor and pipeline parallel training ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dp_tp", "fsdp_tp", "dp_pp", "fsdp_pp"])
def test_four_ranks_train_as_jax_s_mesh_and_as_one_process(ranks, jax_side, layout):
    one = ranks[0]["case_tp_pp_train"]["one"]
    for rank in ranks:
        got = rank["case_tp_pp_train"][layout]
        assert abs(got["loss"] - jax_side["loss"]) < JAX_LOSS
        assert _max_abs(got["params"], jax_side["params"]) < JAX_PARAMS
        assert abs(got["loss"] - one["loss"]) <= PORT * abs(one["loss"])
        assert _max_abs(got["params"], one["params"]) < PORT
    # every rank ends with the same full parameters: under pp the embeddings, heads and norm each stage
    # holds itself stayed equal over the stages
    for rank in ranks[1:]:
        assert _max_abs(rank["case_tp_pp_train"][layout]["params"], ranks[0]["case_tp_pp_train"][layout]["params"]) == 0.0


def test_tp_dropout_drops_what_one_process_drops(ranks):
    """Dropout and attention dropout at (dp 2, tp 2): each tp rank cuts its hidden units' and heads' share
    of the mask one process draws, so the run ends where one process ends over the same two data shares
    (1e-5); and the dropout is live: the run is far from the one without it."""
    one = ranks[0]["case_tp_pp_train"]["one_dropout"]
    for rank in ranks:
        got = rank["case_tp_pp_train"]["dp_tp_dropout"]
        assert abs(got["loss"] - one["loss"]) <= PORT * abs(one["loss"])
        assert _max_abs(got["params"], one["params"]) < PORT
    assert _max_abs(one["params"], ranks[0]["case_tp_pp_train"]["one"]["params"]) > 100 * PORT


@pytest.mark.parametrize("layout", ["dp_tp", "fsdp_tp", "dp_pp", "fsdp_pp"])
def test_a_flat_model_on_the_gathered_params_acts_as_the_laid_out_one(ranks, layout):
    """The rollout eval on rank 0 runs a flat model loaded with the gathered state: its action_pred on each
    data share is the tp-split or pipelined model's."""
    for rank in ranks:
        laid, flat = rank["case_tp_pp_train"][layout]["action_pred"]
        np.testing.assert_allclose(laid, flat, atol=PORT, rtol=PORT)


def test_tp_runs_half_the_heads_and_units_a_rank(ranks):
    for r, rank in enumerate(ranks):
        got = rank["case_tp_pp_train"]["dp_tp"]
        assert got["tp_rank"] == r % 2 and got["local_heads"] == 2
        assert got["qkv_rows"] == (64, 3 * 32) and got["attn_out"] == (64, 32) and got["fc1"] == (64, 64)


def test_pp_stages_hold_their_own_blocks(ranks):
    """Depth 2 in 2 stages over (dp 2, pp 2): ranks 0 and 2 hold block 0's 10 parameters, 1 and 3 block 1's."""
    got = [rank["case_tp_pp_train"]["dp_pp"]["own_blocks"] for rank in ranks]
    assert got == [[f"blocks_{r % 2}"] * 10 for r in range(4)]


def test_tp_places_each_rank_s_own_heads_in_qkv(ranks, jax_side):
    """The fused (in, 3 * dim) kernel is cut on the heads of its (in, 3, heads, head_dim) view: rank r holds
    q, k and v of heads 2r and 2r + 1, not a contiguous third."""
    full = jax_side["init"]["policy.blocks_1.attn.qkv.kernel"].numpy()
    bias = jax_side["init"]["policy.blocks_1.attn.qkv.bias"].numpy()
    out_w = jax_side["init"]["policy.blocks_1.attn.attn_out.weight"].numpy()
    heads = full.reshape(64, 3, 4, 16)
    for rank in ranks:
        got = rank["case_tp_qkv_share"]
        r = got["tp_rank"]
        np.testing.assert_array_equal(got["kernel"], heads[:, :, 2 * r:2 * r + 2].reshape(64, 96))
        np.testing.assert_array_equal(got["bias"], bias.reshape(3, 4, 16)[:, 2 * r:2 * r + 2].reshape(96))
        np.testing.assert_array_equal(got["attn_out"], out_w[:, 32 * r:32 * (r + 1)])


@pytest.mark.parametrize("saved_at", ["tp", "pp"])
def test_tp_and_pp_checkpoints_restore_at_world_one_and_across_layouts(ranks, saved_at):
    """The file is the full state: restored bit for bit in one process and at the other layout.  The next
    AdamW step (lr 1e-3) there is the uninterrupted run's within a tenth of lr: another layout sums the
    gradient in another order, and Adam's normalized step moves a near-zero gradient's rounding up to lr
    (2.2e-5 read on the CPU; the same-layout figure is tests/test_torch_parallel.py's 1e-5)."""
    for rank in ranks:
        got = rank["case_tp_pp_checkpoint"][saved_at]
        for where in ("one", "pp" if saved_at == "tp" else "tp"):
            back = got[where]
            assert back["meta_step"] == 2 and back["restored"]["count"] == got["saved"]["count"] == 2
            assert _max_abs(back["restored"]["params"], got["saved"]["params"]) == 0.0
            assert all(np.array_equal(a, b) for a, b in zip(back["restored"]["mu"] + back["restored"]["nu"],
                                                             got["saved"]["mu"] + got["saved"]["nu"]))
            assert _max_abs(back["resumed"]["params"], got["uninterrupted"]["params"]) < ADAM_ACROSS_LAYOUTS


def test_tp_with_pp_raises_as_jax_asserts():
    with pytest.raises(AssertionError, match="tp inside pp stages is unsupported"):
        tmesh.MeshConfig(tp=2, pp=2).resolve(4)


def test_tp_rules_are_jax_s_specs(jax_side):
    """partition_params over the port's names gives JAX's spec of each leaf at (dp 2, fsdp 2, tp 2)."""
    from arp_tpu.parallel.mesh import _spec_for
    from arp_tpu_torch.parallel.step import trainable_parameters

    model = W.arpdt({k: v.numpy() for k, v in jax_side["init"].items()}, jax_side["batch"])
    got = tmesh.partition_params(model, {"dp": 2, "fsdp": 2, "tp": 2})
    flax_params = jax.device_get(_setup()[1].params)
    flat = {"/".join(k): v for k, v in _flatten_keys(flax_params)}
    for name, p in trainable_parameters(model):
        path, shape = tmesh.flax_leaf(name, tuple(p.shape))
        assert flat[path].shape == shape, name
        assert got[name] == tuple(_spec_for(path, shape, 2, 2, 2)), name
    assert got["policy.blocks_0.attn.qkv.kernel"] == ("fsdp", "tp")
    assert got["policy.blocks_0.mlp.fc2.weight"] == ("tp", "fsdp")


def _flatten_keys(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten_keys(v, prefix + (k,))
        else:
            yield prefix + (k,), v
