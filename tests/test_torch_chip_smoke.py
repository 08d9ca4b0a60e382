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
    assert set(tk.bwd_impl_launch_counts()) == set(tk.fwd_impl_launch_counts()) == {"mma", "simt"}
    # the forward kernels, counted by implementation too
    assert set(chip_smoke.FWD_KERNELS) == {c for c in counters if c.startswith("attention")} - set(chip_smoke.BWD_KERNELS)
    assert all(rows[c][2].endswith("attention_fwd.cu") for c in chip_smoke.FWD_KERNELS)
    # every attention row is read from a path that runs in bfloat16, on the tensor cores
    assert all(chip_smoke.PATH_IMPLS[rows[c][5]] == ("mma", "mma") for c in chip_smoke.FWD_KERNELS + chip_smoke.BWD_KERNELS)


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


@pytest.mark.parametrize(
    "launches,impls,ok",
    [
        # serving: 40 forward launches on the tensor cores, no backward
        (_fake_path(40, fwd_impl={"mma": 40, "simt": 0}, bwd_impl={"mma": 0, "simt": 0}), ("mma", "mma"), True),
        (_fake_path(40, fwd_impl={"mma": 39, "simt": 1}, bwd_impl={"mma": 0, "simt": 0}), ("mma", "mma"), False),
        # a train step: 16 + 16 + 16
        (_fake_path(16, bwd=16, fwd_impl={"mma": 16, "simt": 0}, bwd_impl={"mma": 32, "simt": 0}), ("mma", "mma"), True),
        (_fake_path(16, bwd=16, fwd_impl={"mma": 0, "simt": 16}, bwd_impl={"mma": 32, "simt": 0}), ("mma", "mma"), False),
        (_fake_path(16, bwd=16, fwd_impl={"mma": 16, "simt": 0}, bwd_impl={"mma": 16, "simt": 16}), ("mma", "mma"), False),
        # the AR train step: causal only
        (_fake_path(causal=8, bwd_causal=8, fwd_impl={"mma": 8, "simt": 0}, bwd_impl={"mma": 16, "simt": 0}), ("mma", "mma"), True),
        # the AR example: a bf16 tokenizer and an fp32 AR model
        (_fake_path(24, causal=800, bwd_causal=800, fwd_impl={"mma": 24, "simt": 800}, bwd_impl={"mma": 0, "simt": 1600}),
         ("mma", "simt"), True),
        (_fake_path(24, causal=800, bwd_causal=800, fwd_impl={"mma": 824, "simt": 0}, bwd_impl={"mma": 0, "simt": 1600}),
         ("mma", "simt"), False),
        # no forward launch at all
        (_fake_path(fwd_impl={"mma": 0, "simt": 0}, bwd_impl={"mma": 0, "simt": 0}), ("mma", "mma"), False),
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
