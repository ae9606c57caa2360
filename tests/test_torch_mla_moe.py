"""The ``"mla_moe"`` tower (``models.mla_moe``: latent attention and routed
experts) against its plain float32 reference (``models.reference_mla_moe``),
at a tiny size on the CPU: width 64, 4 heads, nope 16, rope 8, values 16,
kv rank 32, 8 experts with top-2, 1 shared, expert width 32, dense width
96, 1 dense + 2 MoE layers, 12 positions with masked rows.

fp32 towers on the CPU run the same algebra as the reference in another
order (the grouped products, the permutation, the batched combine), so
embeddings agree to 1e-5 of their largest entry and every leaf's gradient
to 1e-4 of its largest entry.  The ``requires_cuda`` cases hold the flash
kernels at latent attention's widths (192 for queries and keys, 128 for
values) to the plain attention, and the tower's CUDA path (bf16) to the
reference routed by the tower's own choices."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

import pytest
import torch

from crossclr_tpu_torch.models import TowerConfig, mla_moe
from crossclr_tpu_torch.models import reference_mla_moe as reference
from crossclr_tpu_torch.models.encoders import DualEncoder
from crossclr_tpu_torch.training import TrainConfig, Trainer
from crossclr_tpu_torch.training.trainer import init_params
from crossclr_tpu_torch.utils.config import load_config

from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the module (its name is shadowed by the function in ops/__init__)
port = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
ROOT = Path(__file__).resolve().parents[1]

TINY = dict(kind="mla_moe", input_dim=20, embed_dim=16, hidden_dim=96, num_layers=3,
            num_heads=4, max_seq_len=12, dtype=torch.float32, attention="flash",
            model_dim=64, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, moe_intermediate_size=32, n_routed_experts=8,
            num_experts_per_tok=2, n_shared_experts=1, first_k_dense_replace=1)
VIDEO = TowerConfig(kind="mlp", input_dim=10, embed_dim=16, hidden_dim=32,
                    dtype=torch.float32)
EMB_TOL, GRAD_TOL = 1e-5, 1e-4


def _model(seed=3, bias=True, **over):
    cfg = TowerConfig(**{**TINY, **over})
    model = DualEncoder(VIDEO, cfg)
    init_params(model, seed)
    if not bias:
        for name, b in model.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.zero_()
    return cfg, model


def _inputs(b=5, s=12, masked=True, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, TINY["input_dim"], generator=gen)
    lengths = torch.tensor([s, 3, 7, 1, s, 5, 9, 2][:b]).clamp_max(s)
    mask = (torch.arange(s)[None] < lengths[:, None]).int() if masked else None
    return x, mask


def _leaves(model):
    return {k: p for k, p in model.named_parameters() if k.startswith("text_tower.")}


def _ref_params(model):
    return {k: v.detach().clone().requires_grad_(v.is_floating_point())
            for k, v in model.state_dict().items()}


def _close(got, want, tol):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * max(scale, 1e-30), (
        (got - want).abs().max().item(), scale)


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_tower_matches_reference(bias, masked):
    cfg, model = _model(bias=bias)
    x, mask = _inputs(masked=masked)
    emb = model.encode("text", x, mask)
    p = _ref_params(model)
    want = reference.encode(p, cfg, x, mask, prefix="text_tower.")
    _close(emb, want, EMB_TOL)
    g = torch.randn_like(emb)
    leaves = _leaves(model)
    got = torch.autograd.grad(emb, list(leaves.values()), g)
    ref = torch.autograd.grad(want, [p[k] for k in leaves], g, allow_unused=True)
    for name, a, b in zip(leaves, got, ref):
        assert b is not None, name
        _close(a, b, GRAD_TOL)


def test_grouped_experts_match_a_loop_at_uneven_loads():
    """Choices that give expert 0 most rows, others one or two, and expert
    5 none: the grouped products, permutation and combine against the
    reference's loop over experts, forward and every gradient."""
    cfg, model = _model()
    layer = model.text_tower.layers[1].mlp
    gen = torch.Generator().manual_seed(1)
    m = torch.randn(2, 10, cfg.model_dim, generator=gen, requires_grad=True)
    idx = torch.zeros(20, 2, dtype=torch.int64)
    idx[:, 1] = torch.tensor([1, 2, 3, 4, 6, 7, 1, 1, 2, 3, 4, 6, 7, 7, 7, 1, 2, 3, 4, 6])
    assert 5 not in idx
    with mla_moe.routing(model, replay=[idx, idx]):
        out = layer(m)
    p = _ref_params(model)
    m_ref = m.detach().clone().requires_grad_()
    want, _ = reference.moe(p, "text_tower.layers.1.mlp", cfg,
                            m_ref.reshape(20, -1), choices=idx)
    _close(out.reshape(20, -1), want, EMB_TOL)
    g = torch.randn_like(want)
    names = [k for k, _ in layer.named_parameters()]
    got = torch.autograd.grad(out.reshape(20, -1), [m, *layer.parameters()], g)
    ref = torch.autograd.grad(want, [m_ref] + [p[f"text_tower.layers.1.mlp.{k}"]
                                              for k in names], g)
    for name, a, b in zip(["input", *names], got, ref):
        _close(a.reshape(b.shape), b, GRAD_TOL)
    assert torch.all(got[names.index("experts.gate_up") + 1][5] == 0)


def test_dispatch_groups_by_expert_in_token_order():
    idx = torch.tensor([[2, 0], [0, 3], [2, 3]])
    order, offs, counts = mla_moe.dispatch(idx, 4)
    assert counts.tolist() == [2, 0, 2, 2]
    assert offs.tolist() == [2, 2, 4, 6]
    # slots (token, choice) numbered 2·token + choice: expert 0 holds slots
    # 1 and 2, expert 2 slots 0 and 4, expert 3 slots 3 and 5
    assert order.tolist() == [1, 2, 0, 4, 3, 5]


def test_router_weights_worked_by_hand():
    """One token, four experts, top-2: scores s = sigmoid(logits), chosen by
    s + b, weights s over their sum times 2.446."""
    cfg = TowerConfig(**{**TINY, "n_routed_experts": 4, "model_dim": 2})
    layer = mla_moe.MoE(cfg)
    with torch.no_grad():
        layer.gate.weight.copy_(torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                                              [0.0, -1.0]]))
        layer.gate.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 0.5, 0.0]))
    m = torch.tensor([[0.5, 0.25]])
    scores, idx = layer.choose(m)
    s = torch.sigmoid(torch.tensor([0.5, 0.25, -0.5, -0.25]))
    torch.testing.assert_close(scores[0], s)
    # s + b = [0.622, 0.562, 0.878, 0.438]: experts 2 then 0
    assert idx[0].tolist() == [2, 0]
    want = torch.stack([s[2], s[0]]) / (s[2] + s[0] + 1e-20) * 2.446
    torch.testing.assert_close(layer.weights(scores, idx)[0], want)
    assert abs(float(want.sum()) - 2.446) < 1e-6


def _trainer(chunk):
    cfg = TowerConfig(**TINY)
    train = TrainConfig(loss="crossclr_intra", embedding_chunk=chunk, warmup_steps=1,
                        learning_rate=1e-3, seed=5)
    return Trainer(VIDEO, cfg, train, "cpu")


def test_two_pass_gradients_equal_one_pass():
    one, two = _trainer(None), _trainer(4)
    state = one.init_state()
    gen = torch.Generator().manual_seed(2)
    text, mask = _inputs(b=8)
    inputs = (torch.randn(8, VIDEO.input_dim, generator=gen), text, None, mask)
    loss1, _, g1 = one.value_and_grad(state, inputs)
    loss2, _, g2 = two.value_and_grad(state, inputs)
    torch.testing.assert_close(loss2, loss1, rtol=1e-6, atol=0)
    for name in g1:
        _close(g2[name], g1[name], 1e-4)
    # pass 3 ran with pass 1's choices, chunk by chunk
    assert len(two.routes_used) == 2 and len(two.routes_used[0]) == 2
    routes = torch.cat([c[0] for c in two.routes_used])
    torch.testing.assert_close(routes, one.routes_used[0][0])


def test_replayed_choices_are_what_pass_three_routes_by():
    """A chunk re-run with other choices replayed gives other embeddings:
    the replay is used, not ignored."""
    cfg, model = _model()
    x, mask = _inputs()
    with mla_moe.routing(model) as chosen:
        first = model.encode("text", x, mask)
    with mla_moe.routing(model, replay=chosen):
        again = model.encode("text", x, mask)
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    other = [(c + 1) % cfg.n_routed_experts for c in chosen]
    with mla_moe.routing(model, replay=other):
        moved = model.encode("text", x, mask)
    assert (moved - first).abs().max() > 1e-3
    assert model.text_tower.expert_load.sum().item() == 2 * 5 * 12 * 2


def test_published_config_loads_every_width():
    catalog = json.loads((ROOT / "portbench/configs/lsmdc_moonlight.json").read_text())
    for path in ("configs/lsmdc_moonlight.json", "portbench/configs/lsmdc_moonlight.json"):
        text = load_config(ROOT / path).text_tower
        assert text.kind == "mla_moe" and text.dtype == torch.bfloat16
        assert (text.model_dim, text.hidden_dim, text.num_heads) == (
            catalog["hidden_size"], catalog["intermediate_size"],
            catalog["num_attention_heads"])
        for key in ("kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                    "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
                    "n_shared_experts", "first_k_dense_replace", "routed_scaling_factor",
                    "rope_theta", "rms_norm_eps"):
            assert getattr(text, key) == catalog[key], key
        assert text.num_layers == catalog["num_hidden_layers"] == 5
    assert catalog["q_lora_rank"] is None and catalog["n_group"] == 1
    assert catalog["scoring_func"] == "sigmoid" and catalog["topk_method"] == "noaux_tc"


def test_kind_refuses_ring_attention_and_a_model_axis():
    with pytest.raises(ValueError, match="sequence parallelism"):
        mla_moe.MLAMoETower(TowerConfig(**{**TINY, "attention": "ring"}))

    @dataclasses.dataclass
    class Grid:
        n_model: int = 2

    with pytest.raises(ValueError, match="model axis"):
        mla_moe.MLAMoETower(TowerConfig(**TINY), mesh=Grid())


def test_narrow_values_take_the_plain_attention_on_the_cpu():
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn(2, 3, 9, 24, generator=gen, requires_grad=True) for _ in range(2))
    v = torch.randn(2, 3, 9, 16, generator=gen, requires_grad=True)
    mask = (torch.arange(9)[None] < torch.tensor([9, 4])[:, None]).int()
    out = port.flash_attention(q, k, v, mask)
    want = port.mha_reference(q, k, v, mask)
    assert out.shape == (2, 3, 9, 16)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    got = torch.autograd.grad(out.sum(), [q, k, v])
    ref = torch.autograd.grad(want.sum(), [q, k, v])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


# bf16 outputs against fp32 attention on the same bf16 inputs: one bf16
# ulp of the output plus the order of sums (the flash tests' limits); the
# gradients, which sum over S keys, within 2e-2 of their largest entry,
# and 1e-4 where that is nought (one key: dS and so dq and dk are nought,
# the kernel's roundings leave about 1e-6)
BF16_TOL, BF16_GRAD, GRAD_FLOOR = 1.6e-2, 2e-2, 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("s", [1, 96, 200])
def test_cuda_flash_at_mla_widths_matches_plain(cuda, s, masked):
    gen = torch.Generator(device=cuda).manual_seed(s)
    b, h = 3, 4
    q, k = (torch.randn(b, h, s, 192, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn(b, h, s, 128, generator=gen, device=cuda).to(torch.bfloat16)
    mask = None
    if masked:
        lengths = torch.tensor([s, max(s // 2, 1), 1], device=cuda)
        mask = (torch.arange(s, device=cuda)[None] < lengths[:, None]).int()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(port.launch_counts)
    out = port.flash_attention(*leaves, mask)
    g = torch.randn(out.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert all(port.launch_counts[n] == before[n] + 1 for n in port.KERNELS)
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    want = port.mha_reference(*ref_leaves, mask)
    ref = torch.autograd.grad(want, ref_leaves, g.float())
    assert out.shape == (b, h, s, 128) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want, atol=BF16_TOL, rtol=BF16_TOL)
    for a, w in zip(got, ref):
        assert a.dtype == torch.bfloat16
        err = (a.float() - w).abs().max().item()
        assert err <= max(BF16_GRAD * w.abs().max().item(), GRAD_FLOOR), err


@pytest.mark.requires_cuda
def test_cuda_tower_matches_reference_routed_alike(cuda):
    """The bf16 tower at MLA's head widths (192 / 128) and a small residual
    width, grouped products on the card, against the fp32 reference routed
    by the tower's own choices: embeddings within 3e-2 of their largest
    entry, each leaf's gradient norm within 5e-2 of the reference's."""
    over = dict(model_dim=256, num_heads=2, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128, kv_lora_rank=64, moe_intermediate_size=64,
                hidden_dim=128, dtype=torch.bfloat16)
    cfg, model = _model(**over)
    model = model.to(cuda)
    x, mask = (t.to(cuda) for t in _inputs(b=6, s=40) if t is not None)
    with mla_moe.routing(model) as chosen:
        emb = model.encode("text", x, mask)
    p = {k: v.detach().float().requires_grad_(v.is_floating_point())
         for k, v in model.state_dict().items()}
    want = reference.encode(p, cfg, x, mask, prefix="text_tower.", choices=chosen)
    _close(emb, want, 3e-2)
    leaves = _leaves(model)
    got = torch.autograd.grad(emb.sum(), list(leaves.values()))
    ref = torch.autograd.grad(want.sum(), [p[k] for k in leaves])
    for name, a, b in zip(leaves, got, ref):
        gap = abs(a.float().norm().item() - b.norm().item()) / b.norm().item()
        assert gap <= 5e-2, (name, gap)


def test_cli_trains_the_moonlight_config_at_tiny_widths(tmp_path):
    """``python -m crossclr_tpu_torch.train --config
    configs/lsmdc_moonlight.json`` with tiny widths, ragged synthetic
    sequences and GradCache chunks of 8: trains, evaluates, checkpoints
    and resumes."""
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.training import CheckpointManager

    text = {"input_dim": 10, "embed_dim": 16, "hidden_dim": 48, "num_layers": 3,
            "num_heads": 2, "model_dim": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
            "qk_rope_head_dim": 4, "v_head_dim": 8, "moe_intermediate_size": 16,
            "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1}
    args = ["--config", str(ROOT / "configs/lsmdc_moonlight.json"), "--device", "cpu",
            "video_tower.input_dim=12", "video_tower.embed_dim=16",
            "video_tower.hidden_dim=32", "video_tower.num_layers=1",
            "video_tower.num_heads=2", *(f"text_tower.{k}={v}" for k, v in text.items()),
            "data.source=synthetic", "data.num_pairs=160", "data.video_dim=12",
            "data.text_dim=10", "data.video_seq_len=8", "data.text_seq_len=6",
            "data.variable_lengths=true", "data.batch_size=16",
            "train.embedding_chunk=8", "train.steps_per_call=2", "train.warmup_steps=2",
            "eval_every=2", "log_every=2", f"checkpoint_dir={tmp_path}"]
    assert train.main(["--steps", "2", *args]) == 0
    mngr = CheckpointManager(tmp_path)
    assert mngr.latest_step() == 2
    assert train.main(["--steps", "4", *args]) == 0
    assert mngr.latest_step() == 4
