"""The port's parallel modes without a group of processes: the mesh
checks against the JAX package's, a rank's local shapes at the 8B widths,
the single-process refusals, the row-statistics mode of K1 and K4 (the
plain versions a row-parallel slice runs on the CPU), and the CPU dryrun.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bitnet_tpu_torch.errors import ConfigError
from bitnet_tpu_torch.gguf.fixtures import MiniModelSpec, generate_mini_gguf
from bitnet_tpu_torch.ops import ternary_matmul as tm
from bitnet_tpu_torch.parallel.comm import Group
from bitnet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


def fake_mesh(dp, tp, d=0, m=0):
    """A (dp, tp) mesh seen from rank (d, m) with no process group: its
    shapes and indices only (slicing needs no collective)."""
    return Mesh({DATA_AXIS: Group(list(range(dp)), d), MODEL_AXIS: Group(list(range(tp)), m)},
                Group(list(range(dp * tp)), d * tp + m), torch.device("cpu"))


@pytest.fixture(scope="module")
def minis(tmp_path_factory):
    d = tmp_path_factory.mktemp("paru")
    out = {}
    for name, spec in {"qk512": MiniModelSpec(hidden_size=512, intermediate_size=1024,
                                              num_heads=4, num_kv_heads=2, quant="qk256"),
                       "qk256": MiniModelSpec(hidden_size=256, intermediate_size=512,
                                              num_heads=4, num_kv_heads=2, quant="qk256")
                       }.items():
        out[name] = generate_mini_gguf(str(d / f"{name}.gguf"), spec).path
    return out


# --------------------------------------------------------------------------
# the mesh checks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,dp,tp,fuse", [(3, 2, 1, False), (4, 1, 4, False),
                                           (4, 2, 2, True)])
def test_validate_mesh_for_is_the_jax_check(minis, B, dp, tp, fuse):
    """The JAX package's refusals, word for word: slots not divisible by
    the data axis, KV heads by the model axis, fused projections."""
    import jax.numpy as jnp

    from bitnet_tpu.errors import ConfigError as JConfigError
    from bitnet_tpu.models import load_model as jload
    from bitnet_tpu.models.bitnet import fuse_block_params as jfuse
    from bitnet_tpu.parallel import make_mesh as jmesh
    from bitnet_tpu.parallel.sharding import validate_mesh_for as jvalidate
    from bitnet_tpu_torch.models.bitnet import fuse_block_params
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.sharding import validate_mesh_for

    jcfg, jp, _ = jload(minis["qk512"], param_dtype=jnp.float32)
    cfg, p, _ = load_model(minis["qk512"], param_dtype=torch.float32, device="cpu")
    if fuse:
        jp = dataclasses.replace(jp, blocks=jfuse(jp.blocks))
        p = dataclasses.replace(p, blocks=fuse_block_params(p.blocks))
    with pytest.raises(JConfigError) as want:
        jvalidate(jcfg, B, jmesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp]), jp)
    with pytest.raises(ConfigError) as got:
        validate_mesh_for(cfg, B, fake_mesh(dp, tp), p)
    assert str(got.value) == str(want.value)


def test_a_slice_must_be_whole_granules(minis):
    """Where K / tp of a row-parallel linear is not whole 256-row granules
    of the words (the 256-wide mini at tp = 2: o's K = 128 a rank) the port
    refuses; the JAX package slices across granules there."""
    from bitnet_tpu_torch.models.loader import load_model
    from bitnet_tpu_torch.parallel.sharding import validate_mesh_for

    cfg, p, _ = load_model(minis["qk256"], param_dtype=torch.float32, device="cpu")
    with pytest.raises(ConfigError, match="wo: K / tp = 128 is not whole 256-row"):
        validate_mesh_for(cfg, 2, fake_mesh(1, 2), p)
    cfg, p, _ = load_model(minis["qk512"], param_dtype=torch.float32, device="cpu")
    validate_mesh_for(cfg, 2, fake_mesh(1, 2), p)


def test_the_2b_cannot_shard_on_the_model_axis():
    """The 2B has 5 KV heads (tp in {1, 5}) and F = 6912, not a multiple of
    5: both splits are refused."""
    from bitnet_tpu_torch.models.synthetic import BITNET_2B4T
    from bitnet_tpu_torch.parallel.sharding import validate_mesh_for

    blocks = dataclasses.make_dataclass("B", [("wqkv", object, None), ("w_gateup", object, None)])
    params = dataclasses.make_dataclass("P", [("blocks", object), ("lm_head", object, None)])(
        blocks())
    with pytest.raises(ConfigError, match="num_kv_heads 5 not divisible by model axis 2"):
        validate_mesh_for(BITNET_2B4T, 2, fake_mesh(1, 2), params)
    with pytest.raises(ConfigError, match="intermediate_size 6912 not divisible"):
        validate_mesh_for(BITNET_2B4T, 2, fake_mesh(1, 5), params)


def _lin(K, N, L=1):
    from bitnet_tpu_torch.ops.linear import TernaryLinear

    return TernaryLinear(kind="qk256", k=K, n=N,
                         packed=torch.zeros((L, K // 16, N), dtype=torch.int32),
                         scales=torch.ones(L), col_scales=torch.ones((L, N)))


@pytest.mark.parametrize("m", [0, 1])
def test_a_ranks_local_shapes_at_the_8b_widths(m):
    """One layer at the Llama-3-8B-1.58 widths (H = 4096, F = 14336, 32 / 8
    heads of 128) sliced for rank m of tp = 2, no collective: q N = 2048,
    k / v N = 512, gate / up N = 7168 (K = 4096); o K = 2048 and down K =
    7168 (N = 4096), each K whole 256-row granules and each N whole
    64-column blocks; the slice is the rank's part of the words."""
    from bitnet_tpu_torch.models.bitnet import BitNetParams, BlockParams
    from bitnet_tpu_torch.models.synthetic import LLAMA3_8B_158
    from bitnet_tpu_torch.parallel.sharding import shard_params, validate_mesh_for

    cfg = LLAMA3_8B_158
    H, F, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    g = torch.Generator().manual_seed(0)
    lins = {"wq": _lin(H, cfg.num_heads * D), "wk": _lin(H, cfg.num_kv_heads * D),
            "wv": _lin(H, cfg.num_kv_heads * D), "wo": _lin(cfg.num_heads * D, H),
            "w_gate": _lin(H, F), "w_up": _lin(H, F), "w_down": _lin(F, H)}
    for lin in lins.values():
        lin.packed.random_(-2 ** 31, 2 ** 31 - 1, generator=g)
    blocks = BlockParams(attn_norm=torch.ones((1, H)), ffn_norm=torch.ones((1, H)), **lins)
    params = BitNetParams(embed=torch.zeros((8, H)), blocks=blocks,
                          final_norm=torch.ones(H), rope_sin=torch.zeros((4, D // 2)),
                          rope_cos=torch.zeros((4, D // 2)))
    mesh = fake_mesh(1, 2, m=m)
    validate_mesh_for(cfg, 2, mesh, params)
    sb = shard_params(mesh, cfg, params).blocks
    want = {"wq": (4096, 2048), "wk": (4096, 512), "wv": (4096, 512),
            "w_gate": (4096, 7168), "w_up": (4096, 7168), "wo": (2048, 4096),
            "w_down": (7168, 4096)}
    for name, (K, N) in want.items():
        lin, full = getattr(sb, name), lins[name]
        assert (lin.k, lin.n) == (K, N) and lin.packed.shape == (1, K // 16, N), name
        assert K % 256 == 0 and N % 64 == 0
        assert lin.shard.kind == ("row" if name in ("wo", "w_down") else "col")
        if lin.shard.kind == "col":
            assert torch.equal(lin.packed, full.packed[:, :, m * N:(m + 1) * N])
            assert lin.col_scales.shape == (1, N)
        else:
            assert torch.equal(lin.packed, full.packed[:, m * K // 16:(m + 1) * K // 16])
            assert lin.col_scales.shape == (1, N) and lin.shard.full == 2 * K
    assert mesh.local_cfg(cfg).num_heads == 16 and mesh.local_cfg(cfg).num_kv_heads == 4


# --------------------------------------------------------------------------
# one process
# --------------------------------------------------------------------------
def test_a_mesh_of_ranks_needs_torch_distributed(minis):
    """A single process builds only the mesh of one rank; a larger mesh,
    and ``shard_to_mesh`` onto one, raise a ConfigError that says so.
    ``shard_to_mesh(1, 1)`` keeps the engine's tokens; a second call and
    fused projections are refused."""
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.parallel import make_mesh

    with pytest.raises(ConfigError, match="needs torch.distributed initialized"):
        make_mesh(dp=1, tp=2, device="cpu")
    ec = EngineConfig(max_seq_len=64, max_batch_size=2, compute_dtype="f32",
                      kv_cache_dtype="f32", kernel_path="w2a8")
    eng = InferenceEngine.from_gguf(minis["qk512"], ec, device="cpu")
    gen = GenerationConfig(max_new_tokens=6, greedy=True)
    want = eng.generate([2, 7, 11], gen).token_ids
    with pytest.raises(ConfigError, match="needs torch.distributed initialized"):
        eng.shard_to_mesh(dp=2, tp=1)
    assert eng.shard_to_mesh(dp=1, tp=1).generate([2, 7, 11], gen).token_ids == want
    assert not eng.mesh.live and eng._segment_steps() == 1
    with pytest.raises(ConfigError, match="sharded already"):
        eng.shard_to_mesh(dp=1, tp=1)
    fused = InferenceEngine.from_gguf(minis["qk512"], ec.replace(fuse_projections=True),
                                      device="cpu")
    with pytest.raises(ConfigError, match="unfused"):
        fused.shard_to_mesh(dp=1, tp=1)


def test_init_distributed_is_a_no_op_without_a_coordinator(monkeypatch):
    from bitnet_tpu_torch.parallel.multihost import init_distributed, is_primary

    monkeypatch.delenv("BITNET_COORDINATOR", raising=False)
    assert init_distributed() is False and is_primary()


def test_a_single_group_is_the_identity():
    g = Group([0], 0)
    t = torch.arange(6.0).reshape(2, 3)
    assert g.all_reduce(t, "max") is t and g.broadcast(t) is t
    assert g.all_gather(t, 1) is t and g.ring_shift(t) is t


def test_the_dryrun_matches_the_unsharded_port(minis):
    """``dryrun_multihost``: two gloo processes on the CPU, tp = 2, one
    prefill; rank 0's next tokens are the unsharded engine's."""
    from bitnet_tpu_torch.config import EngineConfig
    from bitnet_tpu_torch.engine.engine import InferenceEngine
    from bitnet_tpu_torch.parallel.multihost import dryrun_multihost

    got = dryrun_multihost(minis["qk512"], 2, tp=2)
    eng = InferenceEngine.from_gguf(minis["qk512"], EngineConfig(
        max_seq_len=32, max_batch_size=2, compute_dtype="f32", kv_cache_dtype="f32"),
        device="cpu")
    lg = eng.prefill_batch([[t % eng.cfg.vocab_size for t in range(8)]] * 2)
    assert got == torch.argmax(lg, -1).tolist()


# --------------------------------------------------------------------------
# the row-statistics mode of K1 and K4 (plain versions)
# --------------------------------------------------------------------------
def _words(K, N, seed):
    from bitnet_tpu_torch.ops.linear import repack_codes_torch

    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, 4, (K, N), generator=g, dtype=torch.uint8)
    return repack_codes_torch(codes)[None]


@pytest.mark.parametrize("M,gamma", [(1, True), (2, False), (8, True)])
def test_k1_row_statistics_mode_sums_to_the_whole_row(M, gamma):
    """Two slices of K = 1024 through K1 with the whole row's statistics
    (sum of squares over 1024 values, the normed row's absmax), summed,
    give the whole row's K1 output within 1e-5 of its largest value; the
    slices' int8 codes are the whole row's (exact on these rows)."""
    K, N = 1024, 256
    g = torch.Generator().manual_seed(M)
    x = torch.randn((M, K), generator=g)
    w = _words(K, N, 1)
    sv = torch.rand((1, N), generator=g) + 0.5
    gm = (torch.rand((1, K), generator=g) + 0.5) if gamma else None
    whole = tm.ternary_matmul_w2a8_normed(0, x, w, sv, gm, K, N)
    ss = (x * x).sum(1)
    xn = x if gm is None else (x * tm.norm_factor(ss, K, 1e-5)[:, None]) * gm
    stats = torch.stack([ss, xn.abs().amax(1)], 1).contiguous()
    h = K // 2
    parts = [tm.ternary_matmul_w2a8_normed(
        0, x[:, i * h:(i + 1) * h].contiguous(), w[:, i * h // 16:(i + 1) * h // 16]
        .contiguous(), sv, None if gm is None else gm[:, i * h:(i + 1) * h].contiguous(),
        h, N, stats=stats, k_full=K) for i in range(2)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * whole.abs().max().item())
    q_whole = tm.quantize_rows(tm.w2a8_preamble_plain(x, None if gm is None else gm[0],
                                                      1e-5, False))[0]
    q_part = tm.quantize_rows(tm.w2a8_preamble_plain(
        x[:, :h], None if gm is None else gm[0, :h], 1e-5, False, stats, K), stats[:, 1])[0]
    if gm is None:
        assert torch.equal(q_part, q_whole[:, :h])
    else:   # rsqrt (the plain whole row) against 1 / sqrt: a code may move by one
        assert (q_part.int() - q_whole[:, :h].int()).abs().max() <= 1


def test_k4_row_statistics_mode_takes_the_absmax():
    """K4 with ``stats``: the rows quantize by the absmax given (the whole
    row's), so two slices sum to the whole row's output."""
    M, K, N = 80, 1024, 128
    g = torch.Generator().manual_seed(5)
    x = torch.randn((M, K), generator=g)
    w = _words(K, N, 2)
    sv = torch.ones((1, N))
    whole = tm.ternary_matmul_w2a8(0, x, w, sv, K, N)
    stats = torch.stack([torch.zeros(M), x.abs().amax(1)], 1).contiguous()
    h = K // 2
    parts = [tm.ternary_matmul_w2a8(0, x[:, i * h:(i + 1) * h].contiguous(),
                                    w[:, i * h // 16:(i + 1) * h // 16].contiguous(), sv, h,
                                    N, stats=stats) for i in range(2)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * whole.abs().max().item())


def test_the_row_statistics_operand_is_checked():
    K, N = 256, 128
    x = torch.randn((2, K))
    w = _words(K, N, 3)
    sv = torch.ones((1, N))
    with pytest.raises(ValueError, match="stats must be contiguous f32"):
        tm.ternary_matmul_w2a8_normed(0, x, w, sv, None, K, N,
                                      stats=torch.ones((2, 3)), k_full=K)
    with pytest.raises(ValueError, match="k_full"):
        tm.ternary_matmul_w2a8_normed(0, x, w, sv, None, K, N, stats=torch.ones((2, 2)),
                                      k_full=K // 2)
