"""The port's torch tower import (``utils.torch_import``) against the JAX
package's, on the same live torch towers.

The torch mirrors are ``tests/test_torch_import.py``'s (MLP and
transformer towers whose attribute names are the Flax module names, fp32,
tanh GELU, LayerNorm eps 1e-6).  Each converts through the JAX package's
``params_from_torch`` into Flax params and through the port's onto the
port's towers.  Held: the port's entries equal, bit for bit, the JAX
params moved across by ``utils.params.state_dict_from_flax``; the port's
tower outputs within 1e-6 of the Flax towers' (fp32, the same sums in
another order) and within the JAX test's limits of the torch mirror's;
the reverse conversion equal to the JAX package's and exact on a round
trip; the JAX version's errors (a missing key, an unconsumed entry under
``strict``, a shape, a rename collision); and the import CLI's checkpoint
through ``eval`` and ``serve``.
"""

import json

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.models import DualEncoder, MLPTower, TransformerTower
from crossclr_tpu_torch.models.encoders import TowerConfig
from crossclr_tpu_torch.utils.params import state_dict_from_flax
from crossclr_tpu_torch.utils.torch_import import (
    dual_encoder_params_from_torch,
    logit_scale_from_torch,
    params_from_torch,
    state_dict_from_params,
)
from test_torch_import import TorchMLPTower, TorchTransformerTower

OUT_ATOL = 1e-6
MLP = dict(kind="mlp", input_dim=24, embed_dim=16, hidden_dim=40, num_layers=2)
TR = dict(kind="transformer", input_dim=20, embed_dim=16, hidden_dim=48,
          num_layers=2, num_heads=4, max_seq_len=7)
# the mirror names its attention MultiHeadDotProductAttention_0; the flash
# tower's module is _MHA_0, reached through rename=
TO_FLASH = {f"block_{i}.MultiHeadDotProductAttention_0.": f"block_{i}._MHA_0."
            for i in range(2)}


def _port_tower(fields, attention="xla"):
    extra = {"attention": attention} if fields["kind"] == "transformer" else {}
    cfg = TowerConfig(**fields, dtype=torch.float32, **extra)
    gen = torch.Generator()
    tower = MLPTower(cfg) if cfg.kind == "mlp" else TransformerTower(cfg, gen)
    return tower.eval()


def _jax_params(fields, x, mask, sd):
    """The JAX import of ``sd`` onto the Flax tower (attention "xla", the
    mirror's names), and that tower's output on ``x``."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import MLPTower as JMLP
    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.models import TransformerTower as JTR
    from crossclr_tpu.utils.torch_import import params_from_torch as jimport

    cfg = JTowerConfig(**fields, dtype=jnp.float32)
    tower = JMLP(cfg) if cfg.kind == "mlp" else JTR(cfg)
    args = (jnp.asarray(x),) if mask is None else (jnp.asarray(x), jnp.asarray(mask))
    template = jax.eval_shape(
        lambda: tower.init(jax.random.PRNGKey(0), *args))["params"]
    params = jimport(template, sd)
    return jax.device_get(params), np.asarray(tower.apply({"params": params}, *args))


def _inputs(fields, masked):
    rng = np.random.default_rng(0)
    if fields["kind"] == "mlp":
        return rng.standard_normal((6, fields["input_dim"])).astype(np.float32), None
    b, s = 5, fields["max_seq_len"]
    x = rng.standard_normal((b, s, fields["input_dim"])).astype(np.float32)
    if not masked:
        return x, None
    lengths = rng.integers(1, s + 1, size=b)
    return x, (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)


CASES = [("mlp", MLP, "xla", False), ("transformer", TR, "xla", False),
         ("transformer-masked", TR, "xla", True),
         ("transformer-flash", TR, "flash", True)]


@pytest.mark.parametrize("name,fields,attention,masked", CASES,
                         ids=[c[0] for c in CASES])
def test_tower_import_matches_the_jax_import(name, fields, attention, masked):
    torch.manual_seed(1)
    mirror = TorchMLPTower(_port_tower(fields).cfg) if fields["kind"] == "mlp" \
        else TorchTransformerTower(_port_tower(fields).cfg)
    sd = mirror.state_dict()
    x, mask = _inputs(fields, masked)
    tower = _port_tower(fields, attention)
    rename = TO_FLASH if attention == "flash" else None

    got = params_from_torch(tower, sd, rename=rename)
    jparams, jout = _jax_params(fields, x, mask, sd)
    want = state_dict_from_flax(jparams, tower)  # maps the attention name
    assert list(got) == list(tower.state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k

    tower.load_state_dict(got)
    t_mask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        out = (tower(torch.from_numpy(x)) if mask is None and fields["kind"] == "mlp"
               else tower(torch.from_numpy(x), t_mask)).numpy()
        ref = (mirror(torch.from_numpy(x)) if fields["kind"] == "mlp"
               else mirror(torch.from_numpy(x), t_mask)).numpy()
    np.testing.assert_allclose(out, jout, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5)


def test_reverse_conversion_matches_the_jax_one_and_round_trips():
    """``state_dict_from_params`` equals the JAX package's reverse of the
    same weights (its Flax params), and importing it back is exact."""
    from crossclr_tpu.utils.torch_import import state_dict_from_params as jreverse

    torch.manual_seed(2)
    tower = _port_tower(TR)
    sd = TorchTransformerTower(tower.cfg).state_dict()
    x, mask = _inputs(TR, True)
    jparams, _ = _jax_params(TR, x, mask, sd)
    params = params_from_torch(tower, sd)
    back, jback = state_dict_from_params(params), jreverse(jparams)
    assert sorted(back) == sorted(jback)
    for k in back:
        np.testing.assert_array_equal(back[k], jback[k])
    again = params_from_torch(tower, back)
    for k, v in params.items():
        assert torch.equal(again[k], v), k
    # the rename runs afterward; a collapsing one raises
    renamed = state_dict_from_params(params, rename={"block_1.": "layer1."})
    assert "layer1.MultiHeadDotProductAttention_0.query.weight" in renamed
    with pytest.raises(ValueError, match="both map"):
        state_dict_from_params(params, rename=lambda k: "same")
    bf16 = state_dict_from_params({k: v.bfloat16() for k, v in params.items()})
    assert bf16["pos_embed"].dtype == np.float32


def _mlp_setup():
    torch.manual_seed(0)
    tower = _port_tower(MLP)
    return tower, dict(TorchMLPTower(tower.cfg).state_dict())


def test_import_errors():
    tower, sd = _mlp_setup()
    missing = {k: v for k, v in sd.items() if k != "fc1.weight"}
    with pytest.raises(KeyError, match="fc1.weight"):
        params_from_torch(tower, missing)

    extra = {**sd, "extra.weight": torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="not consumed"):
        params_from_torch(tower, extra)
    params_from_torch(tower, extra, strict=False)  # tolerated
    params_from_torch(tower, {**sd, "bn.num_batches_tracked": torch.zeros(())})

    wrong = {**sd, "fc1.weight": torch.zeros(MLP["hidden_dim"] + 1, MLP["input_dim"])}
    with pytest.raises(ValueError, match="does not match"):
        params_from_torch(tower, wrong)
    # a Linear weight is never reshaped, even at the same size
    flipped = {**sd, "fc1.weight": sd["fc1.weight"].reshape(MLP["input_dim"], -1)}
    with pytest.raises(ValueError, match="does not match"):
        params_from_torch(tower, flipped)

    shadow = {**sd, "shadow_fc1.weight": torch.zeros_like(sd["fc1.weight"])}
    with pytest.raises(ValueError, match="maps both"):
        params_from_torch(tower, shadow, rename={"shadow_fc1.": "fc1."})


def test_rename_forms_and_bfloat16():
    """A dict (longest prefix first) and a callable rename give the direct
    import; a bf16 state_dict converts to the bf16-rounded weights."""
    tower, sd = _mlp_setup()
    direct = params_from_torch(tower, sd)
    natural = {k.replace("skip", "proj_skip").replace("fc", "mlp.fc"): v
               for k, v in sd.items()}
    by_call = params_from_torch(
        tower, natural,
        rename=lambda k: k.replace("proj_skip", "skip").replace("mlp.fc", "fc"))
    nested = {f"tower.{k}": v for k, v in sd.items()}
    by_map = params_from_torch(tower, {**nested, "tower.norm.extra": torch.zeros(1)},
                               rename={"tower.": "", "tower.norm.extra": "ignored"},
                               strict=False)
    for k in direct:
        assert torch.equal(by_call[k], direct[k]) and torch.equal(by_map[k], direct[k])
    bf = params_from_torch(tower, {k: v.bfloat16() for k, v in sd.items()})
    for k in direct:
        assert bf[k].dtype == torch.float32
        assert torch.equal(bf[k], direct[k].bfloat16().float())


def test_dual_encoder_import_and_logit_scale():
    tower, sd = _mlp_setup()
    model = DualEncoder(tower.cfg, tower.cfg)
    with torch.no_grad():
        model.logit_scale.fill_(0.5)
    kept = dual_encoder_params_from_torch(model, sd, sd)
    assert float(kept["logit_scale"]) == 0.5
    assert set(kept) == set(model.state_dict())
    crit = dual_encoder_params_from_torch(model, sd, sd, {"logit_scale": torch.tensor([0.37])})
    got = logit_scale_from_torch({"logit_scale": torch.tensor([0.37])})
    assert got.shape == () and got.dtype == torch.float32
    assert float(crit["logit_scale"]) == pytest.approx(0.37, rel=1e-6)
    with pytest.raises(KeyError, match="logit_scale"):
        logit_scale_from_torch({})
    with pytest.raises(KeyError, match="unexpected top-level"):
        dual_encoder_params_from_torch({**model.state_dict(), "extra": torch.zeros(1)},
                                       sd, sd)
    model.load_state_dict(crit)


def test_import_cli_checkpoint_evaluates_and_serves(tmp_path, capsys):
    """``python -m crossclr_tpu_torch.import_torch_checkpoint`` writes a
    step-0 checkpoint; ``eval`` encodes through it as the torch towers do,
    and ``serve --checkpoint-dir`` starts from it."""
    from crossclr_tpu_torch import eval as teval
    from crossclr_tpu_torch import import_torch_checkpoint as cli
    from crossclr_tpu_torch.serve import build_service
    from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

    torch.manual_seed(2)
    video_cfg = _port_tower(MLP).cfg
    text_cfg = TowerConfig(kind="mlp", input_dim=18, embed_dim=16, hidden_dim=32,
                           num_layers=1, dtype=torch.float32)
    tv, tt = TorchMLPTower(video_cfg), TorchMLPTower(text_cfg)
    flat = {f"video_tower.{k}": v for k, v in tv.state_dict().items()}
    flat.update({f"text_tower.{k}": v for k, v in tt.state_dict().items()})
    flat["criterion.logit_scale"] = torch.full([], 0.25)
    torch.save(flat, tmp_path / "towers.pt")
    overrides = [
        "video_tower.input_dim=24", "video_tower.embed_dim=16",
        "video_tower.hidden_dim=40", "video_tower.num_layers=2",
        "video_tower.dtype=float32", "text_tower.input_dim=18",
        "text_tower.embed_dim=16", "text_tower.hidden_dim=32",
        "text_tower.num_layers=1", "text_tower.dtype=float32",
        "train.ema_decay=0.9", "data.num_pairs=32", "data.batch_size=8",
        "data.video_dim=24", "data.text_dim=18",
    ]
    assert cli.main(["--torch-ckpt", str(tmp_path / "towers.pt"), "--output",
                     str(tmp_path / "ckpt"), "--criterion-prefix", "criterion.",
                     *overrides]) == 0
    assert "(step 0)" in capsys.readouterr().out
    saved = torch.load(tmp_path / "ckpt" / "step_0.pt", weights_only=True)
    assert saved["step"] == 0 and float(saved["model"]["logit_scale"]) == 0.25
    for k, v in saved["ema"].items():  # the average starts at the import
        assert torch.equal(v, saved["model"][k])

    assert teval.main(["--split", "all", "--device", "cpu", "--ema",
                       "--checkpoint-dir", str(tmp_path / "ckpt"),
                       "--embeddings-output", str(tmp_path / "emb.npz"),
                       *overrides]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["step"] == 0 and metrics["rows"] == 32
    cfg = apply_overrides(ExperimentConfig(), overrides)
    from crossclr_tpu_torch.data import dataset_from_config

    data, _ = dataset_from_config(cfg.data)
    with np.load(tmp_path / "emb.npz") as z, torch.no_grad():
        np.testing.assert_allclose(z["video"], tv(torch.from_numpy(
            np.asarray(data.video, np.float32))).numpy(), rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(z["text"], tt(torch.from_numpy(
            np.asarray(data.text, np.float32))).numpy(), rtol=1e-5, atol=2e-5)
    service = build_service(cfg, str(tmp_path / "ckpt"), "video", device="cpu")
    assert service.step == 0 and service.corpus_rows == 32

    nested = {"video": tv.state_dict(), "text": tt.state_dict()}
    torch.save(nested, tmp_path / "nested.pt")
    assert cli.main(["--torch-ckpt", str(tmp_path / "nested.pt"), "--output",
                     str(tmp_path / "ckpt2"), "--video-key", "video",
                     "--text-key", "text", *overrides]) == 0
    with pytest.raises(SystemExit, match="go together"):
        cli.main(["--torch-ckpt", str(tmp_path / "nested.pt"), "--output",
                  str(tmp_path / "ckpt3"), "--video-key", "video", *overrides])
