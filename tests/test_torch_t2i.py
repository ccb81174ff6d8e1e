"""The port's text-to-image metric back ends (``evalx/clip.py``,
``evalx/image_reward.py``) and evaluator (``evalx/t2i_eval.py``) against
the JAX package's towers and against randomly initialised ``transformers``
CLIP and BLIP models, at the tiny configs of ``tests/test_t2i_metrics.py``
(CPU only; no checkpoint download).

Tolerances: embeddings, hidden states and scores within rtol 2e-4 /
atol 2e-5 of ``transformers`` (``tests/test_t2i_metrics.py``'s bounds;
CLIPScores atol 2e-3, rewards rtol 2e-3 / atol 2e-4), and within 1e-5 of
the largest entry of JAX's towers on the same params (float32, measured
at most 4e-7; rewards 1.5e-8 apart).
"""

import numpy as np
import pytest
import torch
import transformers

from llm_compressor_tpu.evalx import clip_jax as jclip
from llm_compressor_tpu.evalx import image_reward_jax as jir
from llm_compressor_tpu_torch.evalx import clip as tclip
from llm_compressor_tpu_torch.evalx import image_reward as tir
from llm_compressor_tpu_torch.evalx import t2i_eval as tt2i
from test_t2i_metrics import _tiny_blip_sd_and_models, _tiny_clip
from torch_port_util import one_torch_thread  # noqa: F401


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _clip_inputs():
    rng = np.random.default_rng(0)
    px = rng.normal(size=(3, 3, 24, 24)).astype(np.float32)
    ids = rng.integers(0, 96, (3, 16)).astype(np.int32)
    ids[:, 0] = 97
    ids[0, 5], ids[1, 10], ids[2, 15] = 98, 98, 98
    return px, ids, (ids == 98).argmax(axis=-1)


@pytest.fixture(scope="module")
def clip_model():
    torch.manual_seed(0)
    hf_cfg = _tiny_clip()
    model = transformers.CLIPModel(hf_cfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return hf_cfg, model, sd


def test_clip_config_from_hf_matches_jax(clip_model):
    hf_cfg = clip_model[0]
    t, j = tclip.clip_config_from_hf(hf_cfg), jclip.clip_config_from_hf(hf_cfg)
    assert t.vision.__dict__ == j.vision.__dict__ and t.text.__dict__ == j.text.__dict__
    assert (t.image_size, t.patch_size, t.text_vocab, t.text_max_pos, t.projection_dim) == \
        (j.image_size, j.patch_size, j.text_vocab, j.text_max_pos, j.projection_dim)


def test_clip_matches_transformers_and_jax(clip_model):
    hf_cfg, model, sd = clip_model
    cfg = tclip.clip_config_from_hf(hf_cfg)
    params = tclip.load_clip_params(sd, cfg, device="cpu")
    jcfg = jclip.clip_config_from_hf(hf_cfg)
    jparams = jclip.load_clip_params(sd, jcfg)
    px, ids, eot = _clip_inputs()
    with torch.no_grad():
        ref_i = model.get_image_features(pixel_values=torch.from_numpy(px))
        ref_t = model.get_text_features(input_ids=torch.from_numpy(ids).long())
        ref_i = torch.nn.functional.normalize(ref_i, dim=-1).numpy()
        ref_t = torch.nn.functional.normalize(ref_t, dim=-1).numpy()
    got_i = tclip.encode_image(params, px, cfg).numpy()
    got_t = tclip.encode_text(params, ids, eot, cfg).numpy()
    np.testing.assert_allclose(got_i, ref_i, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got_t, ref_t, rtol=2e-4, atol=2e-5)
    assert _rel(got_i, jclip.encode_image(jparams, px, cfg=jcfg)) <= 1e-5
    assert _rel(got_t, jclip.encode_text(jparams, ids, eot, cfg=jcfg)) <= 1e-5
    ref_s = np.maximum((ref_i * ref_t).sum(-1) * 100.0, 0.0)
    got_s = tclip.clip_scores(params, cfg, px, ids, eot)
    assert got_s.dtype == np.float32 and got_s.shape == (3,)
    np.testing.assert_allclose(got_s, ref_s, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(got_s, jclip.clip_scores(jparams, jcfg, px, ids, eot),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_encoder_activation_matches_jax(act):
    """``_act``: quick-GELU and the exact GELU (JAX :126-130), within 1e-6
    absolute on [-6, 6] (XLA's and PyTorch's erf differ in the far tail:
    measured 5.3e-7 where the GELU is about -1e-6)."""
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = np.asarray(jclip._act(x, act))
    got = tclip._act(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_clip_preprocess_matches_jax():
    pytest.importorskip("PIL")
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (30, 40, 3)).astype(np.uint8),
            rng.integers(0, 255, (50, 25, 3)).astype(np.uint8)]
    got = tclip.preprocess_images(imgs, image_size=24)
    assert got.shape == (2, 3, 24, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jclip.preprocess_images(imgs, image_size=24))
    zero = tclip.preprocess_images([np.zeros((30, 40, 3), np.uint8)], image_size=24)
    np.testing.assert_allclose(zero[0, 0, 0, 0], -0.48145466 / 0.26862954, rtol=1e-5)


@pytest.fixture(scope="module")
def blip():
    return _tiny_blip_sd_and_models()


BLIP_CFG = dict(v_hidden=32, v_inter=64, v_layers=2, v_heads=4, image_size=24, patch_size=8,
                t_hidden=32, t_inter=64, t_layers=2, t_heads=4, t_vocab=99, t_max_pos=16)


def test_image_reward_matches_transformers_and_jax(blip):
    sd, vm, tm_ = blip
    cfg, jcfg = tir.BlipConfig(**BLIP_CFG), jir.BlipConfig(**BLIP_CFG)
    params = tir.load_image_reward_params(sd, cfg, device="cpu")
    jparams = jir.load_image_reward_params(sd, jcfg)
    assert len(params["vision"]["layers"]) == 2 and len(params["mlp"]) == 5
    rng = np.random.default_rng(0)
    px = rng.normal(size=(2, 3, 24, 24)).astype(np.float32)
    ids = rng.integers(0, 99, (2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int64)
    mask[1, 6:] = 0
    with torch.no_grad():
        ref_img = vm(pixel_values=torch.from_numpy(px)).last_hidden_state
        ref_txt = tm_(input_ids=torch.from_numpy(ids).long(),
                      attention_mask=torch.from_numpy(mask), encoder_hidden_states=ref_img,
                      encoder_attention_mask=torch.ones(ref_img.shape[:2]).long(),
                      is_decoder=False).last_hidden_state
        h = ref_txt[:, 0]
        for idx in (0, 2, 4, 6, 7):
            h = torch.nn.functional.linear(h, torch.from_numpy(sd[f"mlp.layers.{idx}.weight"]),
                                           torch.from_numpy(sd[f"mlp.layers.{idx}.bias"]))
        ref_r = ((h[:, 0] - tir.REWARD_MEAN) / tir.REWARD_STD).numpy()
    got_img = tir.encode_image_blip(params, px, cfg)
    np.testing.assert_allclose(got_img.numpy(), ref_img.numpy(), rtol=2e-4, atol=2e-5)
    j_img = jir.encode_image_blip(jparams, px, cfg=jcfg)
    assert _rel(got_img.numpy(), j_img) <= 1e-5
    got_txt = tir.encode_text_blip(params, ids, mask.astype(np.int32), got_img, cfg)
    np.testing.assert_allclose(got_txt.numpy(), ref_txt.numpy(), rtol=2e-4, atol=2e-5)
    assert _rel(got_txt.numpy(), jir.encode_text_blip(jparams, ids, mask.astype(np.int32),
                                                      j_img, cfg=jcfg)) <= 1e-5
    got_r = tir.reward_scores(params, px, ids, mask.astype(np.int32), cfg)
    assert got_r.dtype == np.float32 and got_r.shape == (2,)
    np.testing.assert_allclose(got_r, ref_r, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got_r, jir.reward_scores(jparams, px, ids, mask.astype(np.int32),
                                                        cfg=jcfg), rtol=1e-5, atol=1e-5)


def test_image_reward_scorer_reads_a_checkpoint(blip, tmp_path, monkeypatch):
    """``ImageRewardScorer`` reads a ``.pt`` state dict and a tokenizer
    (here a stand-in: no tokenizer is downloaded) and scores as
    ``reward_scores`` does."""
    pytest.importorskip("PIL")
    sd = dict(blip[0])
    key = "blip.text_encoder.embeddings.position_embeddings.weight"
    more = np.random.default_rng(4).normal(0, 0.02, (40 - sd[key].shape[0], 32))
    sd[key] = np.concatenate([sd[key], more.astype(np.float32)])   # the scorer pads to 35
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               tmp_path / "ir.pt")

    class Tok:
        def __call__(self, prompts, padding, max_length, truncation, return_tensors):
            ids = np.zeros((len(prompts), max_length), np.int64)
            am = np.zeros_like(ids)
            for i, p in enumerate(prompts):
                t = [3 + ord(c) % 90 for c in p][:max_length]
                ids[i, :len(t)], am[i, :len(t)] = t, 1
            return {"input_ids": ids, "attention_mask": am}

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda path, **kw: Tok()))
    cfg = tir.BlipConfig(**(BLIP_CFG | dict(t_max_pos=40)))
    scorer = tir.ImageRewardScorer(str(tmp_path / "ir.pt"), "tok", cfg=cfg, device="cpu")
    rng = np.random.default_rng(2)
    imgs = [rng.integers(0, 255, (30, 30, 3)).astype(np.uint8) for _ in range(2)]
    prompts = ["a red fox", "a teapot"]
    got = scorer.score(imgs, prompts)
    enc = Tok()(prompts, "max_length", 35, True, "np")
    want = tir.reward_scores(scorer.params, tclip.preprocess_images(imgs, 24),
                             enc["input_ids"], enc["attention_mask"], cfg)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and got.shape == (2,)


def _gen(seed=0):
    rng = np.random.default_rng(seed)
    return lambda prompt, seed=0: rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)


def test_t2i_evaluator_clipscore_plumbing(tmp_path, monkeypatch):
    """``tests/test_t2i_metrics.py::test_t2i_evaluator_clipscore_plumbing``
    on the port: image sets generated and paired with their prompts, the
    scorer's per-pair scores averaged."""
    pytest.importorskip("PIL")

    class StubScorer:
        def __init__(self, path):
            assert path == "/fake/clip"

        def score(self, images, prompts):
            assert len(images) == len(prompts)
            assert all(isinstance(p, str) and p for p in prompts)
            return np.full((len(images),), 31.25)

    monkeypatch.setattr(tclip, "ClipScorer", StubScorer)
    ev = tt2i.T2IEvaluator(_gen(), _gen(), out_dir=str(tmp_path), n_images_per_prompt=1,
                           clip_path="/fake/clip")
    res = ev.eval(metrics="clipscore", categories=["animals"])
    assert res["clipscore"] == 31.25
    assert len(ev.prompts) == len(tt2i.PROMPT_SETS["animals"])
    assert tt2i.PROMPT_SETS == __import__("llm_compressor_tpu.evalx.t2i_eval",
                                          fromlist=["PROMPT_SETS"]).PROMPT_SETS


def test_t2i_evaluator_imagereward_and_missing_metrics(tmp_path, monkeypatch):
    """ImageReward through its scorer; a metric whose back end is missing
    (FID without ``cleanfid``, CLIPScore without a checkpoint path) gives
    nan, as in the JAX package."""
    pytest.importorskip("PIL")
    seen = {}

    class StubReward:
        def __init__(self, ckpt, tok):
            seen["args"] = (ckpt, tok)

        def score(self, images, prompts):
            return np.arange(len(images), dtype=np.float32)

    monkeypatch.setattr(tir, "ImageRewardScorer", StubReward)
    monkeypatch.setitem(__import__("sys").modules, "cleanfid", None)
    ev = tt2i.T2IEvaluator(_gen(1), _gen(2), out_dir=str(tmp_path), n_images_per_prompt=2,
                           image_reward_path="/ir.pt", bert_tokenizer_path="/bert")
    res = ev.eval(metrics="imagereward, fid ,clipscore", categories=["objects"])
    assert seen["args"] == ("/ir.pt", "/bert")
    assert res["imagereward"] == np.mean(np.arange(6))
    assert np.isnan(res["fid"]) and np.isnan(res["clipscore"])
    assert len(list((tmp_path / "origin").glob("*.png"))) == 6
    assert len(list((tmp_path / "compressed").glob("*.png"))) == 6
