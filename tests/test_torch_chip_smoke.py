"""chip_smoke.py, as far as a machine without a CUDA device can hold it.

The script itself needs the card; here its contract without one is checked
(exit code, no result line), that it imports nothing of JAX, and the small
pure functions it computes bounds and agreement with.
"""
import ast
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

from dct_autoencoder_torch import kernels as tk  # noqa: E402


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("there is a CUDA device: the script would run in full")
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], capture_output=True, text=True, cwd=REPO, timeout=300
    )
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and "needs a CUDA device" in run.stderr


def test_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "flax", "optax", "dct_autoencoder_tpu"}, mods


def test_kernel_table_names_every_counter_and_source():
    counters = [row[4] for row in chip_smoke.KERNEL_TABLE]
    assert sorted(counters) == sorted(tk.launch_counts())
    assert set(chip_smoke.SERVING_KERNELS) <= set(counters)
    for key, name, source, replaces, counter, path in chip_smoke.KERNEL_TABLE:
        assert os.path.isfile(os.path.join(REPO, source)), source
        file, line = replaces.split(":")
        with open(os.path.join(REPO, file)) as f:
            text = f.readlines()[int(line) - 1]
        # a causal entry replaces the mask that the three TPU kernels share
        assert ("def _causal_allowed(" if counter.endswith("_causal") else "_kernel(") in text, replaces
        assert counter.endswith("_causal") == name.endswith("_causal") == (path == "ar_train")
    # the causal mode of each attention kernel is an entry of its own, in the same source
    rows = {row[4]: row for row in chip_smoke.KERNEL_TABLE}
    assert tuple(c for c in counters if c.endswith("_causal")) == chip_smoke.CAUSAL_KERNELS
    for counter in chip_smoke.CAUSAL_KERNELS:
        assert rows[counter][2] == rows[counter[: -len("_causal")]][2]
    # the backward kernels, whose launches are also counted by implementation
    assert set(chip_smoke.BWD_KERNELS) == {c for c in counters if "_dq" in c or "_dkv" in c}
    assert all(rows[c][2].endswith("attention_bwd.cu") for c in chip_smoke.BWD_KERNELS)
    assert set(tk.fwd_impl_launch_counts()) == {"mma", "simt", "tf32x3"}
    assert set(tk.bwd_impl_launch_counts()) == {"mma", "simt", "tf32x3"}
    # the forward kernels, counted by implementation too
    assert set(chip_smoke.FWD_KERNELS) == {c for c in counters if c.startswith("attention")} - set(chip_smoke.BWD_KERNELS)
    assert all(rows[c][2].endswith("attention_fwd.cu") for c in chip_smoke.FWD_KERNELS)
    # every attention row is read from a path that runs in bfloat16, on the tensor cores
    assert all(chip_smoke.PATH_IMPLS[rows[c][5]] == chip_smoke.BF16_PATH for c in chip_smoke.FWD_KERNELS + chip_smoke.BWD_KERNELS)


@pytest.mark.parametrize("mode", ["block", "bias"])
def test_library_mask_and_pairs_follow_the_plain_mask(mode):
    """The mask handed to scaled_dot_product_attention allows what the plain
    version allows, and the bound counts exactly those pairs."""
    from dct_autoencoder_torch.kernels import attention as tatt

    g = torch.Generator().manual_seed(0)
    ids = torch.sort(torch.randint(0, 3, (2, 40), generator=g), dim=1).values.int()
    pad = torch.arange(40)[None] >= torch.tensor([33, 40])[:, None]
    q_ids, kv_ids = tatt.segment_ids(ids, pad)
    pos = torch.arange(40)
    allowed = (q_ids[:, None, :, None] == kv_ids[:, None, None, :]) & (pos[None, :] <= pos[:, None])
    mask, pairs = chip_smoke._sdpa_mask_and_pairs(q_ids, kv_ids, mode, torch.float32, causal=True)
    if mode == "block":
        assert pairs == int(allowed.sum()) and mask.dtype == torch.bool
        valid = ~pad
        assert torch.equal(mask[:, 0][valid], allowed[:, 0][valid])
        assert bool(mask.any(dim=-1).all())  # no empty row, padded queries included
        q, k, v = (torch.randn(2, 2, 40, 8, generator=g) for _ in range(3))
        want, _ = tatt.attention_fwd_plain(q, k, v, q_ids, kv_ids, 0.5, mode, causal=True)
        got = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=0.5)
        torch.testing.assert_close(got.transpose(1, 2)[valid], want.transpose(1, 2)[valid], atol=1e-5, rtol=1e-5)
    else:
        assert pairs == allowed.numel() and torch.equal(mask, allowed.float())
    _, non_causal_pairs = chip_smoke._sdpa_mask_and_pairs(q_ids, kv_ids, "block", torch.float32)
    assert non_causal_pairs > int(allowed.sum())


def test_packed_ar_rows_hold_several_images_and_padding():
    cfg = chip_smoke.ar_33m_config()
    (codes, chans, poss, pad, ids), n_images = chip_smoke.packed_ar_rows(cfg, 4, 1024, seed=0, device="cpu")
    assert codes.shape == (4, 1024, 8) and poss.shape == (4, 1024, 2) and n_images > 4
    assert int(codes.max()) < 1024 and int(chans.max()) < 3 and int(poss.max()) < 32
    for r in range(4):
        valid = ~pad[r]
        n = int(valid.sum())
        assert 0 < n < 1024 and bool(valid[:n].all())  # a padded tail
        assert bool((ids[r, 1:n] >= ids[r, : n - 1]).all()) and int(ids[r, n - 1]) >= 1
    # the decoder the repo's AR benchmark uses: 33.6 M parameters
    from dct_autoencoder_torch.models.ar import ARTokenModel

    with torch.device("meta"):
        n_params = sum(p.numel() for p in ARTokenModel(cfg).parameters())
    assert 33.5e6 < n_params < 33.7e6


@pytest.mark.parametrize(
    "nbytes,flops,dtype,want",
    [
        (3.35e9, 0.0, torch.bfloat16, (1.0, "bytes")),
        (0.0, 989e9, torch.bfloat16, (1.0, "operations")),
        (3.35e9, 67e9 * 2, torch.float32, (2.0, "operations")),
    ],
)
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, dtype, want):
    ms, by = chip_smoke.bound(nbytes, flops, dtype)
    assert by == want[1] and ms == pytest.approx(want[0])


@pytest.mark.parametrize("x,want", [(0.75, 2.0**-8), (1.0, 2.0**-7), (3.9, 2.0**-6), (4.0, 2.0**-5), (5.5, 0.03125), (0.0, 0.0)])
def test_bf16_ulp_is_the_spacing_of_bfloat16(x, want):
    assert chip_smoke.bf16_ulp(x) == want
    if x > 0:
        t = torch.tensor(x, dtype=torch.bfloat16)
        up = torch.nextafter(t, torch.tensor(float("inf"), dtype=torch.bfloat16))
        assert float(up) - float(t) == want


def test_code_agreement_counts_missing_tokens_as_disagreeing():
    tok = lambda c, h, w, data: {"c": c, "h": h, "w": w, "data": data}
    a = [{"codes": [tok(0, 0, 0, [1, 2]), tok(1, 0, 0, [3, 4])]}]
    b = [{"codes": [tok(0, 0, 0, [1, 9]), tok(2, 0, 0, [3, 4])]}]
    assert chip_smoke.code_agreement(a, a) == 1.0
    assert chip_smoke.code_agreement(a, b) == pytest.approx(1 / 6)
    json.dumps(a)  # records are JSON-able, as the script prints them


@pytest.mark.parametrize("limit,largest,want", [(2e-2, 1.5, 2e-2), (2e-2, 3.0, 2e-2), (2e-2, 4.0, 2.0**-5), (3e-2, 6.2, 2.0**-5), (3e-2, 0.0, 3e-2)])
def test_simt_tol_is_the_limit_or_one_ulp_of_the_largest_value(limit, largest, want):
    assert chip_smoke.simt_tol(limit, largest) == want


def _fake_path(fwd=0, causal=0, bwd=0, bwd_causal=0, fwd_impl=None, bwd_impl=None):
    counts = {name: 0 for name in tk.launch_counts()}
    counts.update(attention=fwd, attention_causal=causal, attention_dq=bwd, attention_dkv=bwd,
                  attention_dq_causal=bwd_causal, attention_dkv_causal=bwd_causal)
    return {**counts, "fwd_impl": fwd_impl, "bwd_impl": bwd_impl}


BF16, FP32 = chip_smoke.BF16_PATH, chip_smoke.FP32_PATH
AR_EXAMPLE = chip_smoke.PATH_IMPLS["ar_example"]


@pytest.mark.parametrize(
    "launches,impls,ok",
    [
        # serving: 40 forward launches on the tensor cores, no backward
        (_fake_path(40, fwd_impl={"mma": 40, "simt": 0, "tf32x3": 0}, bwd_impl={"mma": 0, "simt": 0, "tf32x3": 0}), BF16, True),
        (_fake_path(40, fwd_impl={"mma": 39, "simt": 1, "tf32x3": 0}, bwd_impl={"mma": 0, "simt": 0, "tf32x3": 0}), BF16, False),
        # a train step: 16 + 16 + 16
        (_fake_path(16, bwd=16, fwd_impl={"mma": 16, "simt": 0, "tf32x3": 0}, bwd_impl={"mma": 32, "simt": 0, "tf32x3": 0}),
         BF16, True),
        (_fake_path(16, bwd=16, fwd_impl={"mma": 0, "simt": 16, "tf32x3": 0}, bwd_impl={"mma": 32, "simt": 0, "tf32x3": 0}),
         BF16, False),
        (_fake_path(16, bwd=16, fwd_impl={"mma": 16, "simt": 0, "tf32x3": 0}, bwd_impl={"mma": 16, "simt": 16, "tf32x3": 0}),
         BF16, False),
        # the AR train step: causal only
        (_fake_path(causal=8, bwd_causal=8, fwd_impl={"mma": 8, "simt": 0, "tf32x3": 0},
                    bwd_impl={"mma": 16, "simt": 0, "tf32x3": 0}), BF16, True),
        # the AR example: a bf16 tokenizer and an fp32 AR model (3xTF32 forward and backward)
        (_fake_path(24, causal=800, bwd_causal=800, fwd_impl={"mma": 24, "simt": 0, "tf32x3": 800},
                    bwd_impl={"mma": 0, "simt": 0, "tf32x3": 1600}), AR_EXAMPLE, True),
        (_fake_path(24, causal=800, bwd_causal=800, fwd_impl={"mma": 824, "simt": 0, "tf32x3": 0},
                    bwd_impl={"mma": 0, "simt": 0, "tf32x3": 1600}), AR_EXAMPLE, False),
        # the fp32 backward on the CUDA-core kernels where 3xTF32 is due
        (_fake_path(24, causal=800, bwd_causal=800, fwd_impl={"mma": 24, "simt": 0, "tf32x3": 800},
                    bwd_impl={"mma": 0, "simt": 1600, "tf32x3": 0}), AR_EXAMPLE, False),
        # the sweep (fp32): forward and backward tf32x3; one simt launch of either fails it
        (_fake_path(480, bwd=480, fwd_impl={"mma": 0, "simt": 0, "tf32x3": 480},
                    bwd_impl={"mma": 0, "simt": 0, "tf32x3": 960}), FP32, True),
        (_fake_path(480, bwd=480, fwd_impl={"mma": 0, "simt": 0, "tf32x3": 480},
                    bwd_impl={"mma": 0, "simt": 1, "tf32x3": 959}), FP32, False),
        (_fake_path(480, bwd=480, fwd_impl={"mma": 0, "simt": 1, "tf32x3": 479},
                    bwd_impl={"mma": 0, "simt": 0, "tf32x3": 960}), FP32, False),
        # no forward launch at all
        (_fake_path(fwd_impl={"mma": 0, "simt": 0, "tf32x3": 0}, bwd_impl={"mma": 0, "simt": 0, "tf32x3": 0}), BF16, False),
    ],
)
def test_check_impl_launches_holds_every_path_to_its_implementations(launches, impls, ok):
    if ok:
        chip_smoke.check_impl_launches(launches, *impls)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_impl_launches(launches, *impls)


@pytest.mark.parametrize(
    "argv,want",
    [
        ([], None),
        (["--profile"], None),
        (["--kernels-only"], "all"),
        (["--kernels-only=dct"], "dct"),
        (["--profile", "--kernels-only=dct"], "dct"),
    ],
)
def test_kernels_only_reads_which_kernels(argv, want):
    assert chip_smoke.kernels_only(argv) == want


def test_kernels_only_refuses_an_unknown_set():
    with pytest.raises(SystemExit, match="--kernels-only"):
        chip_smoke.kernels_only(["--kernels-only=wgmma"])


def test_dct_bounds_count_three_tf32_products():
    """16 x 3 x 448^2: 17.27 GFLOP, 78.7 MB; 3xTF32 bound 0.105 ms, fp32 CUDA cores 0.258 ms, bytes 0.023 ms."""
    b, h, w = 16, 448, 448
    flops = b * 3 * (2 * h * h * w + 2 * h * w * w)
    rows = chip_smoke._dct_bounds(b, flops, 4 * (2 * b * 3 * h * w + 2 * h * w))
    assert flops == pytest.approx(17.27e9, rel=1e-3)
    assert rows["bound_tf32x3_ms"] == pytest.approx(0.1047, rel=1e-3) and rows["bound_by"] == "operations"
    assert rows["bound_ms"] == rows["bound_tf32x3_ms"]
    assert rows["bound_fp32_cuda_cores_ms"] == pytest.approx(0.2578, rel=1e-3)
    assert rows["bound_bytes_ms"] == pytest.approx(0.0235, rel=1e-2)


def test_serving_slice_phases_and_limits():
    """The phases of the serving slice run, in this order, with the limits
    their checks state."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_serving()", "phase_reconstruct_direct_patch14l()", "phase_quantize_gate_r3b()",
             "phase_ar_example_r3b()", "phase_serving_daemon_r3b(example_ar_model)"]
    assert all(call in main for call in order)
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    # reconstruct_direct in uint8 against reconstruct on the same tokens: the JAX package's 40 dB
    assert chip_smoke.MIN_DIRECT_VS_ROUNDTRIP_PSNR_DB == 40.0
    assert inspect.signature(chip_smoke.phase_reconstruct_direct_patch14l).parameters["n_images"].default == 16
    assert inspect.signature(chip_smoke.phase_quantize_gate_r3b).parameters["n_images"].default == 6
    assert inspect.signature(chip_smoke.phase_serving_daemon_r3b).parameters["n_requests"].default == 64
    # the fp32 backward's determinism: 20 runs in each mode, same bits, 1e-5 from
    # the plain versions on the card and from float64
    assert inspect.signature(chip_smoke._attention_bwd_determinism).parameters["runs"].default == 20
    src = inspect.getsource(chip_smoke._attention_bwd_determinism)
    for needle in ("check(differing == 0", "check(outside(first, ref) == 0", "check(outside(first, ref64) == 0",
                   "1e-5 + 1e-5 * r.abs()", "_poison_allocator()"):
        assert needle in src, needle
    assert 'for mode in ("block", "bias")' in inspect.getsource(chip_smoke.phase_kernels)
    # the IDCT at reconstruct_direct's launch shape is held and timed
    assert (8, 448, 448, 14, (448, 448), True) in chip_smoke.DCT_CASES
    # the daemon and reconstruct_direct are paths whose launches are read
    assert {"reconstruct_direct", "serving_daemon"} <= set(chip_smoke.PATH_IMPLS)
    paths = {row[4]: row[5] for row in chip_smoke.KERNEL_TABLE}
    assert all(paths[k] == "serving_daemon" for k in chip_smoke.SERVING_KERNELS)
    # the daemon phase's checks: micro-batching, no backward kernel, bit-equal serving at beta 0, a clean shutdown
    src = inspect.getsource(chip_smoke.phase_serving_daemon_r3b)
    for needle in ("batches < served", "BWD_KERNELS", "np.array_equal(served, local)", "pad_rows_to=8", "pad_tokens_to=128"):
        assert needle in src, needle
    assert "did not shut down" in inspect.getsource(chip_smoke._Daemon)
    # the int8 product ran once a dynamic layer: no layer fell back
    assert "int_mm == len(dynamic_layers)" in inspect.getsource(chip_smoke.phase_reconstruct_direct_patch14l)


def test_cli_shards_hold_the_sizes_the_phase_names(tmp_path):
    """The CLI phase's PNG shards: every size of CLI_IMAGE_SIZES, in order,
    with json sizes that the reader and the resolution filter read."""
    from dct_autoencoder_torch.data.shards import WebDatasetReader

    n = len(chip_smoke.CLI_IMAGE_SIZES) + 2
    chip_smoke.write_image_shards(str(tmp_path), n)
    got = list(WebDatasetReader(str(tmp_path)))
    assert len(got) == n
    for i, s in enumerate(got):
        h, w = chip_smoke.CLI_IMAGE_SIZES[i % len(chip_smoke.CLI_IMAGE_SIZES)]
        assert s["json"] == {"height": h, "width": w} and s["png"].shape == (3, h, w)
    sides = [x for size in chip_smoke.CLI_IMAGE_SIZES for x in size]
    assert min(sides) < 14 * 12 and max(sides) > 768  # the filter and the cap both act


def test_step_clock_times_every_step_and_profiles_its_window(monkeypatch):
    """StepClock wraps loop.make_train_step while train() runs, then restores it."""
    from dct_autoencoder_torch.train import loop
    from test_torch_train import _port_setup, _stream

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    orig = loop.make_train_step
    model, proc = _port_setup()
    with chip_smoke.StepClock((1, 3)) as clock:
        loop.train(model, proc, _stream(proc, 4), batch_size=None, max_iters=4, log=lambda _: None)
    assert loop.make_train_step is orig
    assert len(clock.ends) == 4 and clock.ends == sorted(clock.ends)
    assert clock.state.step == 4 and clock.prof is not None and not clock.prof_running


def test_device_rows_leave_out_user_annotations():
    class Event:
        def __init__(self, key, annotation):
            self.key, self.is_user_annotation = key, annotation
            self.device_type, self.self_device_time_total = torch.autograd.DeviceType.CUDA, 5.0

    class Prof:
        def key_averages(self):
            return [Event("Optimizer.step#AdamW8bit.step", True), Event("void kernel<4>", False)]

    assert [e.key for e in chip_smoke.device_rows(Prof())] == ["void kernel<4>"]


def test_training_cli_slice_phases_run_after_the_train_steps():
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_train_full_width(profile)", "phase_opt8bit_card_vs_cpu()", "phase_train_pixel_r3b()",
             "phase_train_cli_patch14l()", "phase_ar_train_full_width(profile)"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    assert {"train_pixel_r3b", "train_cli"} <= set(chip_smoke.PATH_IMPLS)
    src = inspect.getsource(chip_smoke.phase_train_cli_patch14l)
    for needle in ('launches["dct_patchify"] > 0', 'launches["idct_unpatchify"] > 0', "n_layers * (steps + n_grids)",
                   "prefetch_batches=0", "from_pretrained"):
        assert needle in src, needle
    assert inspect.signature(chip_smoke.phase_train_cli_patch14l).parameters["rows"].default == 64


def test_vq_and_sweep_slice_phases_and_limits():
    """The VQ and sweep phases run after the training CLI and before the AR
    phases, with the limits their checks state.  The VQ paths' launches are
    held to the bf16 tensor-core kernels; the sweep's, in fp32 as its
    command line runs it, to the CUDA-core forward and the 3xTF32 backward."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_train_cli_patch14l()", "phase_train_vq_patch14l(profile)", "phase_train_vq_r3b()",
             "phase_train_cli_vq_r3b(", "phase_sweep_small_448(", "phase_ar_train_full_width(profile)"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    for path in ("train_vq_patch14l", "train_vq_r3b", "train_cli_vq", "sweep"):
        assert chip_smoke.PATH_IMPLS[path] == (chip_smoke.FP32_PATH if path == "sweep" else chip_smoke.BF16_PATH), path
        assert f'launches["{path}"]' in main
    sig = lambda fn: {k: v.default for k, v in inspect.signature(fn).parameters.items()}  # noqa: E731
    assert sig(chip_smoke.phase_train_vq_patch14l) == {"profile": False, "steps": 8, "expire_every": 4, "n_images": 16, "size": 448}
    assert sig(chip_smoke.phase_train_vq_r3b)["n_images"] == 16 and sig(chip_smoke.phase_train_cli_vq_r3b)["steps"] == 4
    assert sig(chip_smoke.phase_sweep_small_448)["trials"] == 5
    assert chip_smoke.MIN_VQ_CODE_AGREEMENT == 0.95
    needles = {
        chip_smoke.phase_train_vq_patch14l: ("vq_expire_threshold=15.0", "_replaced_rows(state, vq.codebook)",
                                             "n_layers * steps", 'before["idct_unpatchify"] == 1',
                                             "max(codes) < cfg.vq_codebook_size", "torch.isfinite(v).all()"),
        chip_smoke.phase_train_vq_r3b: ("MIN_VQ_CODE_AGREEMENT", "MAX_TRAIN_LOSS_REL", "MAX_TRAIN_GRAD_NORM_REL",
                                        "vq_stats.npz", "torch.equal(want[k], got[k])", "same_codes"),
        chip_smoke.phase_train_cli_vq_r3b: ("opt_8bit=True", "vq_expire_every=2", "vq_stats.npz", 'launches["dct_patchify"] > 0',
                                            "DCTPipeline.from_pretrained"),
        chip_smoke.phase_sweep_small_448: ("SMALL_448", "2 * trials", "math.isfinite(r[\"rec_loss\"])",
                                           'launches["dct_patchify"] > 0', "trials > n_startup",
                                           "tpe[n_startup] != rnd[n_startup]"),
    }
    for fn, wants in needles.items():
        src = inspect.getsource(fn)
        for needle in wants:
            assert needle in src, (fn.__name__, needle)
    assert "bfloat16" not in inspect.getsource(chip_smoke.phase_sweep_small_448)


def test_vq_config_keeps_the_published_widths():
    cfg = chip_smoke.vq_config(chip_smoke.PATCH14_L)
    assert cfg.vq_type == "vq" and (cfg.vq_num_codebooks, cfg.vq_codebook_size) == (16, 8192)
    assert cfg.encoder_config.hidden_size == 1024
    assert cfg.encoder_config.num_hidden_layers == cfg.decoder_config.num_hidden_layers == 8
    r3b = chip_smoke.vq_config(os.path.join(chip_smoke.R3B, "config.json"))
    assert r3b.vq_type == "vq" and r3b.encoder_config.hidden_size == 256


def test_replaced_rows_requires_zeroed_moments():
    from types import SimpleNamespace

    cb = torch.nn.Parameter(torch.randn(6, 4))
    adamw = torch.optim.AdamW([cb])
    cb.grad = torch.randn(6, 4)
    adamw.step()
    replaced = torch.tensor([True, False, True, False, False, False])
    state = SimpleNamespace(vq_replaced=replaced, adamw=adamw)
    with pytest.raises(AssertionError, match="Adam moments"):
        chip_smoke._replaced_rows(state, cb)
    for k in ("exp_avg", "exp_avg_sq"):
        adamw.state[cb][k][replaced] = 0.0
    assert chip_smoke._replaced_rows(state, cb) == {"replaced": 2, "codebook_rows": 6}
    with pytest.raises(AssertionError, match="replaced no code"):
        chip_smoke._replaced_rows(SimpleNamespace(vq_replaced=None, adamw=adamw), cb)


def test_offline_tool_phases_and_limits():
    """The offline tools' phases run after the daemon, with the limits and
    checks their contract states; fp32 tool paths are held to the CUDA-core
    forward (and the 3xTF32 backward), bf16 ones to the tensor cores."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_serving_daemon_r3b(example_ar_model)", "phase_tools_prepare_ar_patch14l()", "phase_tools_eval_r3b()",
             "phase_tools_demos_r3b()", "phase_int8_study_patch14l()", "phase_native_packing()"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    assert order[-1] in main.split("for path, impls in PATH_IMPLS.items()")[0]
    for path in ("tools_prepare_ar", "tools_eval_patch14l", "int8_study"):
        assert chip_smoke.PATH_IMPLS[path] == chip_smoke.BF16_PATH, path
    for path in ("tools_eval_r3b", "tools_decode_gif", "tools_diagnose"):
        assert chip_smoke.PATH_IMPLS[path] == chip_smoke.FP32_PATH, path
    assert "tools_testpipe" not in chip_smoke.PATH_IMPLS  # no model, no attention
    assert (chip_smoke.MAX_EVAL_PSNR_DELTA_DB, chip_smoke.MAX_EVAL_PERPLEXITY_REL) == (0.2, 0.02)
    assert (chip_smoke.MAX_DIAGNOSE_PSNR_DELTA_DB, chip_smoke.MAX_TESTPIPE_STAT_DELTA) == (0.1, 1e-3)
    assert chip_smoke.MIN_GIF_FRAME_PSNR_DB == 40.0
    sig = lambda fn: {k: v.default for k, v in inspect.signature(fn).parameters.items()}  # noqa: E731
    assert sig(chip_smoke.phase_tools_prepare_ar_patch14l) == {"n_images": 64, "batch_size": 32, "beta": 0.01, "n_eval": 16}
    assert sig(chip_smoke.phase_tools_eval_r3b) == {"n_images": 8, "size": 448}
    assert sig(chip_smoke.phase_tools_demos_r3b)["n_frames"] == 8
    assert sig(chip_smoke.phase_native_packing)["n_images"] == 1000
    needles = {
        chip_smoke.phase_tools_prepare_ar_patch14l: (
            "PATCH14_L", "save_pretrained", "captions=True", "process_count=2", "caption_of(int(k))",
            "cfg.vq_codebook_size", "pipe.decode(", "device_busy_share", "tool_eval.main(", "n_eval"),
        chip_smoke.phase_tools_eval_r3b: (
            "MIN_CODE_AGREEMENT", "MAX_EVAL_PSNR_DELTA_DB", "MAX_EVAL_PERPLEXITY_REL", 'device="cpu"',
            "len(built.calls) == 1", "nvcc.results", '"ckpt_000001", "model"', 'dtype="float32"'),
        chip_smoke.phase_tools_demos_r3b: (
            "MIN_GIF_FRAME_PSNR_DB", "frame_psnr[-1] > frame_psnr[0]", "MAX_DIAGNOSE_PSNR_DELTA_DB",
            "MAX_TESTPIPE_STAT_DELTA", 'tl["attention"] == 0'),
        chip_smoke.phase_int8_study_patch14l: ("int8_study.main([])", "INT8_STUDY_DYNAMIC", '"int_mm_calls"'),
        chip_smoke.phase_native_packing: ("native.available", "np.array_equal(a, b)", "build_attn_mask"),
    }
    for fn, wants in needles.items():
        src = inspect.getsource(fn)
        for needle in wants:
            assert needle in src, (fn.__name__, needle)


def test_ar_shards_carry_captions_and_sizes_the_phase_names(tmp_path):
    from dct_autoencoder_torch.data.shards import WebDatasetReader

    n = len(chip_smoke.AR_IMAGE_SIZES) + 3
    chip_smoke.write_image_shards(str(tmp_path / "raw"), n, sizes=chip_smoke.AR_IMAGE_SIZES, captions=True,
                                  maxsize=2e6)
    assert len(os.listdir(tmp_path / "raw")) >= 2
    got = list(WebDatasetReader(str(tmp_path / "raw")))
    assert [s["__key__"] for s in got] == [f"{i:08d}" for i in range(n)]
    for i, s in enumerate(got):
        h, w = chip_smoke.AR_IMAGE_SIZES[i % len(chip_smoke.AR_IMAGE_SIZES)]
        assert s["txt"] == chip_smoke.caption_of(i) and s["png"].shape == (3, h, w)
    assert len({chip_smoke.caption_of(i) for i in range(n)}) == n
    sides = [x for size in chip_smoke.AR_IMAGE_SIZES for x in size]
    assert min(sides) >= 336 and max(sides) <= 768  # above the resolution floor, within the cap
    paths = chip_smoke._pngs_from_shards(str(tmp_path / "raw" / "*.tar"), str(tmp_path / "png"), 5)
    assert len(paths) == 5 and all(os.path.isfile(p) for p in paths)


def test_recorder_wraps_and_restores(monkeypatch):
    import types

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    class Thing:
        @classmethod
        def make(cls, x):
            return (cls, x)

        def twice(self, x):
            return 2 * x

    mod = types.SimpleNamespace(f=lambda x: x + 1)
    raw_make = Thing.__dict__["make"]
    with chip_smoke.Recorder(Thing, "make") as made, chip_smoke.Recorder(Thing, "twice") as tw, \
            chip_smoke.Recorder(mod, "f") as fr:
        assert Thing.make(3) == (Thing, 3) and Thing().twice(4) == 8 and mod.f(1) == 2
    assert made.results == [(Thing, 3)] and tw.results == [8] and fr.results == [2]
    assert made.calls[0] == ((3,), {}) and len(made.seconds) == 1
    assert Thing.__dict__["make"] is raw_make and Thing().twice(1) == 2 and mod.f(1) == 2
    assert len(tw.results) == 1  # unwrapped after the block


def test_printed_numbers_are_parsed():
    text = "a.png: PSNR 12.27 dB, per-channel L1 [0.1, 2e-05]\nb.png: PSNR -1.5 dB\n"
    assert chip_smoke._psnr_lines(text) == [12.27, -1.5]
    assert chip_smoke._numbers("std 0.971 mean 0.123 max 2.775 min -2.794") == [0.971, 0.123, 2.775, -2.794]


def test_native_packing_phase_runs_on_the_host(monkeypatch, capsys):
    """The phase is host work only: here it runs whole, native against numpy."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "_card", lambda: "no card: the host alone")
    chip_smoke.phase_native_packing(n_images=200, reps=1)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "native_packing" and line["images"] == 200 and line["rows"] > 1
    assert set(line["host_ms"]) == {"greedy_pack_native", "greedy_pack_numpy_grouping", "pack_and_fill_native",
                                    "group_and_fill_numpy", "attn_mask_native", "attn_mask_numpy"}


def test_parallel_slice_phase_and_limits():
    """The multi-device slice's phase runs last, over a process group of one:
    the sharded step beside the unsharded one must give the same bits, its
    path is held to the tensor cores, and it reads the attention and DCT
    launches of the path."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_native_packing()", "phase_parallel_patch14l()"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    assert order[-1] in main.split("for path, impls in PATH_IMPLS.items()")[0]
    assert 'launches["parallel_patch14l"]' in main
    assert chip_smoke.PATH_IMPLS["parallel_patch14l"] == chip_smoke.BF16_PATH
    assert chip_smoke.MAX_SHARDED_VS_UNSHARDED_DIFF == 0.0
    sig = {k: v.default for k, v in inspect.signature(chip_smoke.phase_parallel_patch14l).parameters.items()}
    assert sig == {"steps": 8, "rows": 64, "n_images": 16, "size": 448}
    src = inspect.getsource(chip_smoke.phase_parallel_patch14l)
    for needle in ('initialize_distributed("cuda"', "world_size=1", 'dist.get_backend() == "nccl"',
                   "with_sequence_parallel", "sharded=True", "data_parallel=True", "run_two_process_check",
                   "torch.cuda.device_count() >= 2", "destroy_process_group", '"dct_patchify"'):
        assert needle in src, needle
    assert "zero1=sharded" in inspect.getsource(chip_smoke._train_steps)


def test_four_card_phase_says_it_did_not_run_on_fewer_cards(capsys):
    """The four-rank check runs after the parallel phase and only where there
    are four cards; elsewhere it prints why, and a rank of it (started with
    --sharded-steps-rank) runs nothing else of the script."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_parallel_patch14l()", "phase_parallel_four_cards()", "for path, impls in PATH_IMPLS.items()"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    assert main.index('"--sharded-steps-rank"') < main.index("phase_environment()")
    assert chip_smoke.MAX_FOUR_CARD_LOSS_REL == 1e-4 and chip_smoke.MAX_FOUR_CARD_GRAD_NORM_REL == 1e-3
    assert len(chip_smoke.FOUR_CARD_CASES) == 6
    chip_smoke.phase_parallel_four_cards()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "parallel_four_cards" and line["ran"] is False and "card" in line["why"]


def test_largest_diff_reads_every_tensor():
    a = {"x": torch.zeros(3), "y": torch.ones(2, 2)}
    b = {"x": torch.tensor([0.0, -0.5, 0.25]), "y": torch.ones(2, 2)}
    assert chip_smoke._largest_diff(a, b) == 0.5
    assert chip_smoke._largest_diff(a, a) == 0.0


def test_pipeline_slice_phase_and_limits():
    """The pipeline slice's phase runs after the parallel one, over a process
    group of one: the pipelined step (one stage, 4 microbatches, ZeRO-1, 8-bit
    moments) beside the unsharded step within its stated limits (the loss
    and grad norm of the steps that share their parameters, then the loss
    and the parameters' updates), its launches and the compile probe's each
    read alone, 1F1B
    against GPipe, the memory study and the compile probe, its attention
    launches held to the tensor cores; the two-stage check says why it did
    not run on one card; four cards add the pipeline cases and the CLI."""
    import inspect

    main = inspect.getsource(chip_smoke.main)
    order = ["phase_parallel_patch14l()", "phase_pipeline_patch14l()", "phase_parallel_four_cards()"]
    assert [main.index(call) for call in order] == sorted(main.index(call) for call in order)
    assert 'launches["pipeline_patch14l"], launches["compile_probe"]' in main
    assert chip_smoke.PATH_IMPLS["pipeline_patch14l"] == chip_smoke.PATH_IMPLS["compile_probe"] == chip_smoke.BF16_PATH
    assert chip_smoke.MAX_PIPELINE_LOSS_REL == 1e-3 and chip_smoke.MAX_PIPELINE_UPDATE_REL == 0.6
    assert chip_smoke.SHARED_STEPS == 2 and chip_smoke.MAX_PIPELINE_SHARED_LOSS_REL == 1e-5
    assert chip_smoke.MAX_PIPELINE_GRAD_NORM_REL == 1e-4
    init = {"x": torch.zeros(2), "n": torch.zeros(2, dtype=torch.long)}
    ref = {"x": torch.tensor([3.0, 0.0]), "n": torch.ones(2, dtype=torch.long)}
    got = {"x": torch.tensor([3.0, 4.0]), "n": torch.zeros(2, dtype=torch.long)}
    assert chip_smoke._update_rel(got, ref, init) == 4.0 / 3.0 and chip_smoke._update_rel(ref, ref, init) == 0.0
    assert chip_smoke.MAX_1F1B_VS_GPIPE_REL == 1e-5 and chip_smoke.MAX_1F1B_TEMP_SPREAD == 0.10
    sig = {k: v.default for k, v in inspect.signature(chip_smoke.phase_pipeline_patch14l).parameters.items()}
    assert sig == {"steps": 8, "rows": 64, "microbatches": 4}
    src = inspect.getsource(chip_smoke.phase_pipeline_patch14l)
    for needle in ('initialize_distributed("cuda"', "world_size=1", "pipeline=microbatches", "opt_8bit=True",
                   "range(SHARED_STEPS)", "_update_rel(piped[3], plain[3], init)",
                   "return step_launches, probe_launches",
                   "_planted_faults(cfg, batches, plain, init, microbatches)", "the planted fault",
                   "pp_memory_study.main", "compile_probe.main", "destroy_process_group",
                   "phase_pipeline_two_cards()", "_f1b_vs_gpipe"):
        assert needle in src, needle
    two = inspect.getsource(chip_smoke.phase_pipeline_two_cards)
    assert "torch.cuda.device_count() >= 2" in two and "pipeline_microbatches=2" in two
    assert "make_pipelined_module(model.module, mesh, pipeline)" in inspect.getsource(chip_smoke._train_steps)
    assert len(chip_smoke.PIPELINE_FOUR_CARD_CASES) == 4
    rank = inspect.getsource(chip_smoke.sharded_steps_rank)
    assert "PIPELINE_FOUR_CARD_CASES" in rank and "four_cards_pipeline_patch14l" in rank
    assert "--pipeline_microbatches" in inspect.getsource(chip_smoke.phase_parallel_four_cards)
    assert chip_smoke._rel(1.0, 2.0) == 0.5


def test_hold_bwd_to_f64_reads_the_ratio_and_the_floor():
    """The 3xTF32 backward is held to float64 at ATTN_F64_RATIO x the fp32
    plain version's error, or ATTN_F64_FLOOR of the case's largest gradient
    where that is more; a TF32-sized error fails."""
    ref = [torch.full((2, 3), 4.0, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.float64),
           torch.ones(2, 3, dtype=torch.float64)]
    plain = [r.float() + 1e-6 for r in ref]
    ok = [r.float() + 7e-6 for r in ref]  # 7x the plain error; under the floor (4e-6) for the zero output too
    row = chip_smoke._hold_bwd_to_f64("case", ok, plain, ref)
    assert 6.0 < row["f64_ratio"] < 8.0 and set(row["f64"]) == {"dq", "dk", "dv"}
    with pytest.raises(AssertionError, match="dq float64 error"):
        chip_smoke._hold_bwd_to_f64("case", [r.float() + 1e-4 for r in ref], plain, ref)
    exact = [r.float() for r in ref]  # the plain version exact: the floor decides
    chip_smoke._hold_bwd_to_f64("case", [r.float() + 3e-6 for r in ref], exact, ref)
    with pytest.raises(AssertionError):
        chip_smoke._hold_bwd_to_f64("case", [r.float() + 5e-6 for r in ref], exact, ref)


def test_fp32_figures_pick_each_kernel_s_numbers():
    row = {"shape": [4, 8, 3072, 32], "causal": False, "allowed_pairs_share": 1.0,
           "ms": {"fwd": {"simt": 3.0, "tf32x3": 1.0}, "dq": {"simt": 4.0, "tf32x3": 1.4},
                  "dkv": {"simt": 5.4, "tf32x3": 1.7}},
           "max_abs_err": {"simt_fwd": 1e-7, "tf32x3_fwd": 1.5e-7, "simt_dq": 2e-7, "simt_dk": 3e-7, "simt_dv": 4e-7,
                           "tf32x3_dq": 5e-7, "tf32x3_dk": 6e-7, "tf32x3_dv": 7e-7},
           "bound_tf32x3": {"fwd": (0.23, "operations"), "dq": (0.35, "operations"), "dkv": (0.47, "operations")},
           "bound_fp32_cuda_cores": {"fwd": (0.58, "operations"), "dq": (0.87, "operations"), "dkv": (1.15, "operations")},
           "library_fwd_ms": 2.4, "library_bwd_ms": 5.1, "library_fwd_backend": "unpinned (EFFICIENT_ATTENTION)",
           "library_bwd_backend": "EFFICIENT_ATTENTION",
           "plain_fwd_ms": 7.0, "plain_bwd_ms": 11.0}
    fwd, dq, dkv = (chip_smoke.fp32_figures([row], k)[0] for k in ("fwd", "dq", "dkv"))
    assert fwd["ms"] == {"simt": 3.0, "tf32x3": 1.0} and fwd["library_ms"] == 2.4 and fwd["plain_ms"] == 7.0
    assert fwd["max_abs_err"] == {"simt_fwd": 1e-7, "tf32x3_fwd": 1.5e-7}
    assert dq["ms"]["tf32x3"] == 1.4 and dq["bound_ms"] == 0.35 and dq["bound_fp32_cuda_cores_ms"] == 0.87
    assert set(dq["max_abs_err"]) == {"simt_dq", "tf32x3_dq"} and dq["library_ms"] == 5.1
    assert fwd["library_backend"] == "unpinned (EFFICIENT_ATTENTION)" and dq["library_backend"] == "EFFICIENT_ATTENTION"
    assert set(dkv["max_abs_err"]) == {"simt_dk", "simt_dv", "tf32x3_dk", "tf32x3_dv"} and dkv["bound_by"] == "operations"
    assert [s for s, _, _ in chip_smoke.FP32_TIMED_SHAPES] == [(64, 16, 256, 64), (4, 8, 3072, 32), (8, 4, 128, 64)]
