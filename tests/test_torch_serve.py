"""The port's serving engine against the JAX package's, on the CPU.

``ServeEngine.generate`` with greedy decoding gives the same tokens as the
reference's ``ServeEngine(..., jit=False)`` on the same weights (carried
across by ``convert.params_from``), for the dense (smollm-135m), SSM
(mamba2-130m) and hybrid (recurrentgemma-2b) families at reduced width.
The hybrid's prompts run past its reduced local window of 16, or start
short of it and decode past it, so the ring cache wraps.  Also: the
engine's own behaviour (cache growth, early stop, seeded sampling) and the
launcher.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.models import ExecConfig as RefExecConfig  # noqa: E402
from repro.models import Model as RefModel  # noqa: E402
from repro.serve import ServeConfig as RefServeConfig  # noqa: E402
from repro.serve import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.serve.engine import _pad_cache_to  # noqa: E402


def _pair(name, seed=0, impl="xla"):
    cfg = ref_get_arch(name).reduced()
    ref = RefModel(cfg, RefExecConfig(attn_impl=impl, remat="none"))
    params = ref.init(jax.random.PRNGKey(seed))
    port = Model(get_arch(name).reduced(), params=params_from(jax.tree.map(np.asarray, params),
                                                              "cpu"), device="cpu")
    return cfg, ref, params, port


@pytest.mark.parametrize("name,B,S,new,seed", [
    ("smollm-135m", 2, 16, 6, 0),
    ("smollm-135m", 3, 33, 8, 1),
    ("mamba2-130m", 2, 16, 6, 0),
    ("mamba2-130m", 3, 40, 8, 1),
    ("recurrentgemma-2b", 2, 20, 6, 0),
    ("recurrentgemma-2b", 3, 9, 12, 1),
])
def test_greedy_generate_equals_reference(name, B, S, new, seed):
    cfg, ref, params, port = _pair(name, seed)
    tok = np.random.default_rng(seed + 10).integers(0, cfg.vocab, (B, S)).astype(np.int32)
    want = RefServeEngine(ref, params, RefServeConfig(max_len=S + new), jit=False).generate(
        {"tokens": jnp.asarray(tok)}, new)
    got = ServeEngine(port, ServeConfig(max_len=S + new)).generate({"tokens": tok}, new)
    assert got.dtype == torch.int32 and got.shape == (B, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_equals_manual_prefill_and_decode():
    cfg, _, _, port = _pair("smollm-135m", 2)
    B, S, NEW = 2, 12, 5
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, S)))
    out = ServeEngine(port, ServeConfig(max_len=S + NEW)).generate({"tokens": tok}, NEW)
    prefill, decode = make_prefill_step(port), make_decode_step(port)
    last, state = prefill({"tokens": tok})
    state = _pad_cache_to(state, port, S + NEW)
    assert tuple(state[0].shape) == (cfg.n_layers, B, S + NEW, cfg.n_kv_heads, cfg.head_dim)
    want = [torch.argmax(last, -1)]
    for t in range(1, NEW):
        logits, state = decode(state, want[-1], S + t - 1)
        want.append(torch.argmax(logits, -1))
    assert torch.equal(out, torch.stack(want, 1).to(torch.int32))


def test_eos_stops_early_and_sampling_is_seeded():
    cfg, _, _, port = _pair("mamba2-130m", 4)
    tok = np.ones((2, 8), np.int32)
    greedy = ServeEngine(port, ServeConfig(max_len=32)).generate({"tokens": tok[:1]}, 6)
    eos = int(greedy[0, 1])
    assert eos not in greedy[0, :1].tolist()
    stopped = ServeEngine(port, ServeConfig(max_len=32, eos_id=eos)).generate(
        {"tokens": tok[:1]}, 6)
    assert torch.equal(stopped, greedy[:, :2])  # the eos token is the last one emitted
    sampler = ServeEngine(port, ServeConfig(max_len=32, temperature=0.8))
    a = sampler.generate({"tokens": tok}, 6, generator=torch.Generator().manual_seed(5))
    b = sampler.generate({"tokens": tok}, 6, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert bool((a >= 0).all()) and bool((a < cfg.vocab).all())


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    assert serve_cli.main(["--arch", "smollm-135m", "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "4", "--device", "cpu"]) == 0
    assert "generated (2, 4) tokens" in capsys.readouterr().out
    assert serve_cli.main(["--arch", "mamba2-130m", "--batch", "2", "--prompt-len", "8",
                           "--new-tokens", "4", "--device", "cpu", "--temperature", "0.7"]) == 0


def test_launcher_serves_recurrentgemma_on_the_cpu(capsys):
    """The reference's CLI test drives ``--arch recurrentgemma-2b``; the
    port's launcher serves the same reduced hybrid, past its window."""
    assert serve_cli.main(["--arch", "recurrentgemma-2b", "--batch", "2", "--prompt-len", "24",
                           "--new-tokens", "4", "--device", "cpu"]) == 0
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_hybrid_state_passes_through_the_engine_fixed_size():
    """The hybrid's decode state is fixed-size: ``_pad_cache_to`` hands it
    on unchanged, its ring caches hold ``local_window`` slots whatever the
    prompt, and ``init_state`` ignores ``max_len``."""
    cfg, _, _, port = _pair("recurrentgemma-2b", 3)
    tok = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 5)))
    _, state = make_prefill_step(port)({"tokens": tok})
    assert _pad_cache_to(state, port, 64) is state
    zero = port.init_state(2, 64)
    assert sorted(zero) == sorted(state) == ["super"]
    for i in ("0", "1", "2"):
        for k, v in state["super"][i].items():
            assert v.shape == zero["super"][i][k].shape and v.dtype == zero["super"][i][k].dtype
    assert state["super"]["2"]["ck"].shape == (1, 2, cfg.local_window, cfg.n_kv_heads,
                                               cfg.head_dim)


def test_engine_and_launcher_ask_for_cuda_by_default():
    """Built without device=, the model (and so the engine on it) and the
    launcher go to the card; on a host without one they raise."""
    if torch.cuda.is_available():
        assert ServeEngine(Model(get_arch("smollm-135m").reduced())).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(Model(get_arch("smollm-135m").reduced()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "mamba2-130m", "--batch", "1", "--prompt-len", "4",
                        "--new-tokens", "2"])
