"""The port's studies against the JAX package's, on the CPU.

  * tools/ab_report.py: the three tests of tests/test_ab_report.py, and the
    same report JSON from both packages for the same two runs (exactly);
  * tools/nu_codebook_study.py: the five tests of
    tests/test_nu_codebook_study.py (the u4 candidate equal to the port's
    _unsigned_codebook() within 1e-6 relative, as JAX's test holds it to
    JAX's), and collect_moment_pairs over the train_state.pt of one CPU
    step of the tiny model: the moments paired with their parameters in
    named_parameters() order, laid out as JAX's, and an 8-bit state
    refused by name;
  * tools/int8_study.py: its synthetic batch equal to the one the JAX study
    draws from the same seed, and codes_of / report on the tiny config
    with the JAX model's weights: the float and int8 models' codes equal to
    JAX's (a bit may differ only where JAX's LFQ input before the sign is
    within the slack of tests/test_torch_quant.py), the same agreements.
"""
import json
import sys

import numpy as np
import pytest
import torch

from dct_autoencoder_torch.tools import ab_report, int8_study, nu_codebook_study
from dct_autoencoder_torch.train.opt8bit import _unsigned_codebook
from dct_autoencoder_tpu.tools import ab_report as jax_ab_report
from dct_autoencoder_tpu.tools import nu_codebook_study as jax_nu


# ---------------------------------------------------------------- ab_report


def test_images_seen_trapezoid_constant_rate():
    metrics = [{"step": s, "images_per_batch": 10} for s in range(0, 501, 50)]
    series = ab_report.images_seen_series(metrics)
    assert series[-1] == (500, 5000.0)
    assert ab_report.images_at(series, 250) == 2500.0
    assert ab_report.images_at(series, 600) == 6000.0


def test_images_seen_dedups_restart_overlap():
    metrics = (
        [{"step": s, "images_per_batch": 10} for s in range(0, 201, 50)]
        + [{"step": s, "images_per_batch": 20} for s in range(100, 301, 50)]
    )
    by_step = dict(ab_report.images_seen_series(metrics))
    assert by_step[100] == 500.0 + 0.5 * (10 + 20) * 50
    assert by_step[300] == by_step[100] + 20 * 200


def _write_run(d, rate, psnrs):
    d.mkdir()
    (d / "metrics.jsonl").write_text(
        "\n".join(json.dumps({"step": s, "images_per_batch": rate + s % 7, "loss": -0.1}) for s in range(0, 401, 50))
    )
    (d / "eval.jsonl").write_text(
        json.dumps({"step": "ckpt_000200", "psnr": psnrs[0], "perplexity": 100.0, "psnr_per_image": [1.0, 2.0]})
        + "\n" + json.dumps({"step": "model", "psnr": psnrs[1], "perplexity": 200.0})
    )
    (d / "eval_train.jsonl").write_text(json.dumps({"step": "model", "psnr": psnrs[1] + 1.0, "perplexity": 210.5}))


def test_arm_record_merges_evals(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    (d / "metrics.jsonl").write_text(
        "\n".join(json.dumps({"step": s, "images_per_batch": 10, "loss": -0.1}) for s in range(0, 401, 50))
    )
    (d / "eval.jsonl").write_text(
        json.dumps({"step": "ckpt_000200", "psnr": 11.0, "perplexity": 100.0}) + "\n"
        + json.dumps({"step": "model", "psnr": 12.0, "perplexity": 200.0})
    )
    rec = ab_report.arm_record(str(d))
    assert rec["max_step"] == 400
    rows = rec["held_out"]
    assert rows[0]["step"] == 200 and rows[0]["images_seen_est"] == 2000
    assert rows[1]["step"] == 400 and rows[1]["psnr"] == 12.0
    assert rec["train_fixtures"] == []


def test_ab_report_json_equals_jax(tmp_path, monkeypatch, capsys):
    _write_run(tmp_path / "a", 10, (11.0, 12.25))
    _write_run(tmp_path / "b", 14, (10.5, 12.75))
    reports = {}
    for name, mod in (("port", ab_report), ("jax", jax_ab_report)):
        out = tmp_path / f"{name}.json"
        monkeypatch.setattr(sys, "argv", ["ab_report", "--arm", f"a={tmp_path / 'a'}", "--arm", f"b={tmp_path / 'b'}",
                                          "--out", str(out)])
        returned = mod.main()
        reports[name] = (out.read_text(), capsys.readouterr().out.replace(str(tmp_path / f"{name}.json"), "<out>"))
        assert json.loads(reports[name][0]) == returned
    assert reports["port"] == reports["jax"]
    assert len(json.loads(reports["port"][0])["b"]["held_out"]) == 2


# ---------------------------------------------------------------- nu codebook study


def test_candidate_codebooks_well_formed():
    for name, make in nu_codebook_study.CANDIDATES.items():
        cb = make()
        assert cb.shape == (256,), name
        assert cb.min() >= 0.0 and cb.max() == pytest.approx(1.0), name
        assert np.all(np.diff(np.sort(cb)) >= 0), name
        np.testing.assert_array_equal(cb, jax_nu.CANDIDATES[name]())


def test_u4_matches_shipped_codebook():
    np.testing.assert_allclose(nu_codebook_study.CANDIDATES["u4"](), _unsigned_codebook().numpy(), rtol=1e-6, atol=0)


def test_quant_roundtrip_error_bounded():
    x = np.random.default_rng(0).lognormal(mean=-8.0, sigma=3.0, size=(4096,))
    cb = np.sort(nu_codebook_study.CANDIDATES["u4"]())
    xh = nu_codebook_study.quant_roundtrip(x, cb)
    np.testing.assert_array_equal(xh, jax_nu.quant_roundtrip(x, cb))
    blocks = x.reshape(-1, 256)
    idx = blocks.argmax(axis=1)
    np.testing.assert_allclose(xh.reshape(-1, 256)[np.arange(len(idx)), idx], blocks.max(axis=1), rtol=1e-12)
    assert np.mean(np.abs(xh - x)) / np.mean(np.abs(x)) < 0.05


def test_quant_roundtrip_pins_opt8bit_quantizer():
    """The study's numpy round trip tracks the port's blockwise quantizer."""
    from dct_autoencoder_torch.train import opt8bit

    assert opt8bit.BLOCK == nu_codebook_study.BLOCK == 256
    x = np.random.default_rng(1).lognormal(mean=-8.0, sigma=3.0, size=(1024,)).astype(np.float32)
    cb = opt8bit._unsigned_codebook()
    codes, absmax = opt8bit.quantize_blockwise(torch.from_numpy(x), cb)
    ref = opt8bit.dequantize_blockwise(codes, absmax, cb, x.shape, x.size).numpy()
    ours = nu_codebook_study.quant_roundtrip(x, np.sort(cb.numpy().astype(np.float64)))
    np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=0)


def test_exact_zero_rounding_hazard_is_measurable():
    cb_u2 = np.sort(nu_codebook_study.CANDIDATES["u2"]())
    cb_u4 = np.sort(nu_codebook_study.CANDIDATES["u4"]())
    tiny = np.full((256,), 1e-7)
    tiny[0] = 1.0
    assert nu_codebook_study.quant_roundtrip(tiny, cb_u2)[1:].min() == 0.0
    assert nu_codebook_study.quant_roundtrip(tiny, cb_u4)[1:].min() > 0.0


def _one_step_run(tmp_path, opt_8bit):
    from dct_autoencoder_torch.train import loop
    from test_torch_train import _port_setup, _stream

    model, proc = _port_setup()
    out = tmp_path / ("run8" if opt_8bit else "run")
    loop.train(model, proc, _stream(proc, 2), batch_size=None, max_iters=1, save_every=1, opt_8bit=opt_8bit,
               prefetch_batches=0, out_dir=str(out), log=lambda _: None)
    return model, out


def test_collect_moment_pairs_reads_a_port_train_state(tmp_path):
    model, out = _one_step_run(tmp_path, opt_8bit=False)
    path = nu_codebook_study.resolve_train_state(str(out))
    pairs = list(nu_codebook_study.collect_moment_pairs(path))
    payload = torch.load(path, weights_only=True)
    moments = payload["opt_state"]["state"]
    named = list(model.module.named_parameters())
    assert len(pairs) == len(named) == len(moments)
    by_name = {name: (mu, nu) for name, mu, nu in pairs}
    assert [name for name, _, _ in pairs] == sorted(by_name)
    for i, (name, p) in enumerate(named):
        jax_name = "/" + name.replace(".", "/").replace("layers/", "layers_")
        if p.ndim == 2 and name.endswith("weight"):
            jax_name = jax_name[: -len("weight")] + "kernel"
            want = (moments[i]["exp_avg"].numpy().T, moments[i]["exp_avg_sq"].numpy().T)
        else:
            jax_name = jax_name[: -len("weight")] + "scale" if name.endswith("weight") else jax_name
            want = (moments[i]["exp_avg"].numpy(), moments[i]["exp_avg_sq"].numpy())
        got = by_name[jax_name]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert all((nu >= 0).all() for _, _, nu in pairs) and any(np.abs(mu).max() > 0 for _, mu, _ in pairs)
    result = nu_codebook_study.main(["--train_state", str(out), "--out", str(tmp_path / "r.json")])
    assert result["n_tensor_pairs"] == len(pairs) and set(result["results"]) == set(nu_codebook_study.CANDIDATES)
    assert json.loads((tmp_path / "r.json").read_text()) == result


def test_collect_moment_pairs_refuses_an_8bit_state(tmp_path):
    _, out = _one_step_run(tmp_path, opt_8bit=True)
    with pytest.raises(SystemExit, match="8-bit"):
        list(nu_codebook_study.collect_moment_pairs(nu_codebook_study.resolve_train_state(str(out))))


# ---------------------------------------------------------------- int8 study


def _jax_study_batch(cfg, rows, seq, seed):
    """The JAX study's synthetic batch (dct_autoencoder_tpu/tools/int8_study.py main), drawn as it draws it."""
    import jax.numpy as jnp

    from dct_autoencoder_tpu.patches.container import DCTPatches

    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, 4, size=(rows, seq))).astype(np.int32)
    lengths = rng.integers(seq // 2, seq, size=(rows,))
    pad = np.arange(seq)[None, :] >= lengths[:, None]
    return DCTPatches(
        patches=jnp.asarray(rng.standard_normal((rows, seq, cfg.patch_dim)).astype(np.float32)),
        key_pad_mask=jnp.asarray(pad),
        attn_mask=None,
        batched_image_ids=jnp.asarray(ids),
        patch_channels=jnp.asarray(rng.integers(0, cfg.image_channels, (rows, seq)).astype(np.int32)),
        patch_positions=jnp.asarray(
            rng.integers(0, min(cfg.max_patch_h, cfg.max_patch_w), (rows, seq, 2)).astype(np.int32)
        ),
    )


def test_int8_study_codes_and_report_match_jax(capsys):
    import jax.numpy as jnp

    from dct_autoencoder_torch.models import quant as tquant
    from dct_autoencoder_tpu.models import quant as jquant
    from dct_autoencoder_tpu.models.autoencoder import DCTAutoencoder as JaxAE
    from dct_autoencoder_tpu.models.patchnorm import calibrate_patchnorm_batch as jax_calibrate
    from test_model import tiny_config
    from test_torch_quant import _assert_ids_match
    from test_torch_train import port_of

    from dct_autoencoder_tpu.models.config import DCTAutoencoderConfig

    # through a dict, so that the two stacks get configs of their own (tiny_config shares one)
    cfg = DCTAutoencoderConfig.from_dict(tiny_config("lfq").to_dict())
    jb = _jax_study_batch(cfg, rows=3, seq=64, seed=0)
    tb = int8_study.synthetic_batch(cfg, 3, 64, np.random.default_rng(0), "cpu")
    for name in ("patches", "key_pad_mask", "batched_image_ids", "patch_channels", "patch_positions"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)

    jm = JaxAE(cfg, dtype=jnp.float32, seed=0)
    jm.patchnorm, _ = jax_calibrate(jm.patchnorm, jb)
    tm = port_of(jm)
    jnb, tnb = jm.normalize_(jb), tm.normalize_(tb)
    valid = ~np.asarray(jb.key_pad_mask)

    def jax_codes(m):
        return np.asarray(m.encode(jnb, training=False)[1])[valid]

    codes_fp = int8_study.codes_of(tm, tnb)
    np.testing.assert_array_equal(codes_fp, jax_codes(jm))
    for kw in (dict(mode="weight_only"), dict(mode="dynamic"), dict(mode="dynamic", encoder_bf16_layers=(0,))):
        tq, jq = tquant.quantize_model_for_serving(tm, **kw), jquant.quantize_model_for_serving(jm, **kw)
        full = np.zeros(tnb.patches.shape[:2] + (cfg.vq_num_codebooks,), np.int64)
        full[valid] = int8_study.codes_of(tq, tnb)
        _assert_ids_match(tq, jq, jnb, full)
        line = int8_study.report(kw["mode"], tq, tnb, codes_fp)
        want = float((jax_codes(jq) == jax_codes(jm)).mean())
        assert line["token_agreement"] == round(want, 5), (kw, line, want)
        assert line["flipped_per_10k"] == round((1 - want) * 1e4, 1)
        assert (line["int_mm_calls"] > 0) == (kw["mode"] == "dynamic")
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


def test_int8_study_main_runs_every_variant_on_the_cpu(tmp_path, capsys):
    from test_model import tiny_config

    cfg = tiny_config("lfq")
    for stack in (cfg.encoder_config, cfg.decoder_config):  # widths that groups of 128 divide
        stack.hidden_size, stack.intermediate_size = 128, 256
    cfg_path = tmp_path / "tiny.json"
    cfg.to_json_file(str(cfg_path))
    lines = int8_study.main(["--config", str(cfg_path), "--rows", "2", "--seq", "32", "--device", "cpu", "--per_layer"])
    names = [line["variant"] for line in lines]
    assert names == ["weight_only", "dynamic", "dynamic_last1_bf16", "dynamic_last2_bf16", "dynamic_first2_bf16",
                     "weight_only_g128", "dynamic_g128", "dynamic_g128_first2_bf16", "noise_equiv_seed1",
                     "noise_equiv_seed2", "only_layer_0_dynamic", "only_layer_1_dynamic"]
    assert all(0.0 <= line["token_agreement"] <= 1.0 for line in lines)
    # dynamic_last2_bf16 and dynamic_first2_bf16 keep both of the tiny encoder's layers in float
    for line in lines:
        assert (line["int_mm_calls"] > 0) == (line["variant"].startswith(("dynamic", "only_layer"))
                                              and not line["variant"].endswith("2_bf16")), line
    assert capsys.readouterr().out.startswith("# ")
