"""The port's 8-bit AdamW (train/opt8bit.py) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and given to both packages.

Tolerances:
  * codebooks, and `quantize_blockwise` codes and absmax on the same
    inputs: equal, bit for bit;
  * 5 updates of the whole optimizer (global-norm clip, warmup-cosine
    schedule, 8-bit moments, weight decay) from the same parameters and
    gradients, at learning rate 1e-3: parameters atol 1e-6.  With
    gradients under the clip's limit, every code and absmax equal, bit for
    bit (c1 = 1 - b1**count gave the same float32 in both).  With clipped
    gradients, the two packages sum the global norm in another order, so
    the clipped gradients differ by an ulp or so: absmax rtol 1e-5 and at
    least 99.9 % of the codes equal (1 of ~11,000 measured to differ).
    JAX's update runs op by op here, as written: under jax.jit XLA
    contracts multiply-adds, and the jitted update itself differs from the
    eager one by an ulp of absmax, up to 2 flipped codes a step and 1e-5 in
    a parameter at a flipped code;
  * the state of a real model: 8-bit < fp32 / 3.5 and < 2.5 bytes a
    parameter, and the same bytes as JAX's (less its two int32 counts);
  * resume through train/checkpoint.py: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dct_autoencoder_torch.train import checkpoint as tckpt
from dct_autoencoder_torch.train import loop as tloop
from dct_autoencoder_torch.train import opt8bit as t8
from dct_autoencoder_tpu.train import loop as jloop
from dct_autoencoder_tpu.train import opt8bit as j8
from test_torch_train import make_case, port_of, to_torch_batch
from torch_threads import one_cpu_thread  # noqa: F401  (fixture)

SHAPES = {"a": (64, 64), "b": (300,), "c": (7, 5, 3), "d": (513,), "e": (256,)}


def test_codebooks_equal_jax():
    for tf, jf in ((t8._signed_codebook, j8._signed_codebook), (t8._unsigned_codebook, j8._unsigned_codebook)):
        got, want = tf(), np.asarray(jf())
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _moment_like(rng):
    """Signed moments, non-negative ones, a zero block, and values on the codebook's midpoints."""
    cb = np.asarray(j8._signed_codebook())
    mids = ((cb[1:] + cb[:-1]) / 2).astype(np.float32)
    return [
        ("signed", rng.standard_normal(5000).astype(np.float32) * 0.01),
        ("unsigned", (np.abs(rng.standard_normal((37, 41))) * 1e-4).astype(np.float32)),
        ("signed", np.concatenate([np.zeros(256, np.float32), rng.standard_normal(300).astype(np.float32)])),
        ("signed", np.concatenate([mids, [1.0]]).astype(np.float32)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_quantize_blockwise_equals_jax(case):
    kind, x = _moment_like(np.random.default_rng(0))[case]
    tcb = t8._signed_codebook() if kind == "signed" else t8._unsigned_codebook()
    jcb = j8._signed_codebook() if kind == "signed" else j8._unsigned_codebook()
    codes, absmax = t8.quantize_blockwise(torch.from_numpy(x), tcb)
    jcodes, jabsmax = j8.quantize_blockwise(jnp.asarray(x), jcb)
    assert codes.dtype == torch.uint8 and codes.shape == (-(-x.size // 256), 256)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(jabsmax))
    back = t8.dequantize_blockwise(codes, absmax, tcb, x.shape, x.size)
    np.testing.assert_array_equal(back.numpy(), np.asarray(j8.dequantize_blockwise(jcodes, jabsmax, jcb, x.shape, x.size)))
    if case < 2:  # the JAX package's round-trip bound
        rel = float(np.linalg.norm(back.numpy() - x) / np.linalg.norm(x))
        assert rel < 0.05, rel


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.names = sorted(arrays)
        for k in self.names:
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(arrays[k].copy())))


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw8bit_steps_match_jax(clipped):
    """5 updates of make_optimizer(opt_8bit=True) from the same parameters and gradients."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    scale = (0.3, 30.0) if clipped else (0.003, 0.03)  # global norms ~20 / ~2000, or below the clip's 5
    grads = [{k: (rng.standard_normal(s) * scale[i == 2]).astype(np.float32) for k, s in SHAPES.items()}
             for i in range(5)]
    kw = dict(learning_rate=1e-3, max_iters=20, warmup_steps=2, opt_8bit=True)

    jtx = jloop.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jtx.init(jp)
    ttx = tloop.make_optimizer(**kw)
    mod = _Params(params)
    adamw = ttx.init(mod)
    assert isinstance(adamw, t8.AdamW8bit)
    plist = [getattr(mod, k) for k in mod.names]

    n_codes = n_equal = 0
    for i, g in enumerate(grads):
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in zip(mod.names, plist):
            p.grad = torch.from_numpy(g[k].copy())
        norm = ttx.apply(adamw, plist, i)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
        for k, p in zip(mod.names, plist):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=f"step {i} {k}")
        j8state = jst[1][0]  # chain(clip, chain(scale_by_adam8bit, ...))
        assert int(j8state.count) == adamw.param_groups[0]["count"] == i + 1
        for k, p in zip(mod.names, plist):
            st = adamw.state[p]
            for field, jtree in (("mu_codes", j8state.mu_codes), ("nu_codes", j8state.nu_codes)):
                got, want = st[field].numpy(), np.asarray(jtree[k])
                n_codes += got.size
                n_equal += int((got == want).sum())
            for field, jtree in (("mu_absmax", j8state.mu_absmax), ("nu_absmax", j8state.nu_absmax)):
                got, want = st[field].numpy(), np.asarray(jtree[k])
                if clipped:  # the clip's global norm sums in another order: a few ulps of scale
                    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"step {i} {k} {field}")
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f"step {i} {k} {field}")
    if clipped:
        assert n_equal >= 0.999 * n_codes, f"{n_codes - n_equal} of {n_codes} codes differ"
    else:
        assert n_equal == n_codes, f"{n_codes - n_equal} of {n_codes} codes differ"


def test_adamw8bit_tracks_fp32_on_quadratic():
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((64, 64)).astype(np.float32)
    target = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    finals = {}
    for name in ("fp32", "8bit"):
        w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        if name == "fp32":
            opt = torch.optim.AdamW([w], lr=1e-2, betas=(0.9, 0.99), weight_decay=0.1)
        else:
            opt = t8.AdamW8bit([w], lr=1e-2, weight_decay=0.1)
        for _ in range(50):
            opt.zero_grad()
            loss = ((w - target) ** 2).mean()
            loss.backward()
            opt.step()
        finals[name] = loss.item()
    # quantization noise must not change convergence materially
    assert abs(finals["8bit"] - finals["fp32"]) / finals["fp32"] < 0.05, finals


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def test_opt8bit_checkpoint_resume_exact(tmp_path, deterministic):
    """(step, save, step) == (step, load, step), bit for bit, through train/checkpoint.py."""
    jm, batch = make_case("tiny_block")
    tb = tloop.prepare_train_batch(to_torch_batch(batch))[0]
    tm = port_of(jm)
    tx = tloop.make_optimizer(learning_rate=1e-3, max_iters=10, warmup_steps=0, opt_8bit=True)
    state = tloop.TrainState.create(tm.module, tx)
    step = tloop.make_train_step(tm.module, tx)
    state, _ = step(state, tm.patchnorm, tb)
    tckpt.save_train_state(str(tmp_path / "ck"), state, tm.patchnorm)
    state, m_cont = step(state, tm.patchnorm, tb)
    cont = {k: v.clone() for k, v in tm.module.state_dict().items()}
    opt_cont = {i: {k: v.clone() for k, v in st.items()} for i, st in state.adamw.state_dict()["state"].items()}

    other = port_of(jm)  # other weights and fresh moments, which the checkpoint replaces
    with torch.no_grad():
        for p in other.module.parameters():
            p.add_(1.0)
    ostate = tloop.TrainState.create(other.module, tx)
    ostate, pn = tckpt.load_train_state(str(tmp_path / "ck"), ostate, other.patchnorm)
    assert ostate.step == 1 and ostate.adamw.param_groups[0]["count"] == 1
    ostate, m_rest = tloop.make_train_step(other.module, tx)(ostate, pn, tb)
    assert m_cont["loss"].item() == m_rest["loss"].item()
    for k, v in other.module.state_dict().items():
        assert torch.equal(v, cont[k]), k
    rest = ostate.adamw.state_dict()["state"]
    for i, st in opt_cont.items():
        for k, v in st.items():
            assert torch.equal(rest[i][k], v), (i, k)
    # the restored state is the optimizer's working buffer, not a copy beside it
    p0 = next(other.module.parameters())
    assert ostate.adamw.state[p0]["mu_codes"].data_ptr() == ostate.adamw._mu_codes.data_ptr()


def test_opt8bit_state_bytes_and_train_step():
    """A train step with 8-bit moments on the tiny model: the state is about
    4x smaller than fp32's and as large as JAX's, and the step's metrics
    (computed before the update) equal the fp32 step's."""
    jm, batch = make_case("tiny_block")
    tb = tloop.prepare_train_batch(to_torch_batch(batch))[0]
    metrics, states = {}, {}
    for bits in (32, 8):
        tm = port_of(jm)
        tx = tloop.make_optimizer(learning_rate=1e-3, max_iters=10, warmup_steps=0, opt_8bit=bits == 8)
        state = tloop.TrainState.create(tm.module, tx)
        before = [p.detach().clone() for p in tm.module.parameters()]
        state, metrics[bits] = tloop.make_train_step(tm.module, tx)(state, tm.patchnorm, tb)
        assert max((p - b).abs().max().item() for p, b in zip(tm.module.parameters(), before)) > 0
        states[bits] = state.adamw
    n_params = sum(p.numel() for p in port_of(jm).module.parameters())
    b32, b8 = t8.opt_state_bytes(states[32]), t8.opt_state_bytes(states[8])
    assert b8 < b32 / 3.5, (b8, b32)
    assert b8 / n_params < 2.5, b8 / n_params
    jtx = jloop.make_optimizer(learning_rate=1e-3, max_iters=10, warmup_steps=0, opt_8bit=True)
    # JAX's state also holds two int32 counts: the moments' and the schedule's
    assert b8 + 8 == j8.opt_state_bytes(jtx.init(jm.params))
    assert np.isfinite(metrics[8]["loss"].item())
    np.testing.assert_allclose(metrics[8]["loss"].item(), metrics[32]["loss"].item(), rtol=1e-6)


def test_adamw8bit_refuses_what_it_cannot_hold():
    a, b = torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="one parameter group"):
        t8.AdamW8bit([{"params": [a]}, {"params": [b]}])
    with pytest.raises(ValueError, match="float32"):
        t8.AdamW8bit([torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))])
    opt = t8.AdamW8bit([a])
    sd = opt.state_dict()
    sd["state"][0]["mu_codes"] = torch.zeros((2, 256), dtype=torch.uint8)
    with pytest.raises(ValueError, match="mu_codes"):
        opt.load_state_dict(sd)
