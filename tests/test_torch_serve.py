"""The port's serving CLI (`repro_torch.launch.serve`): the config it
serves, a CPU run of each arch it serves (the five LMs and bert4rec), and,
marked `cuda`, a run on the card
through the kernels. This file imports neither JAX nor the JAX package, so
the card's tests run where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_serve.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import LMConfig  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.ops import ATTENTION_HEAD_DIMS, ATTENTION_HEAD_DIM_PAIRS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ARGS = ["--batch", "3", "--prompt-len", "9", "--max-new", "5"]


def test_the_cli_serves_a_head_dim_the_kernel_takes():
    smoke = configs.get_arch("qwen2-1.5b").smoke()
    assert smoke.hd not in ATTENTION_HEAD_DIMS
    served = serve.serve_config("qwen2-1.5b")
    assert served.hd == 64 and served.head_dim == 64
    # only the head dim moves
    assert {k: v for k, v in vars(served).items() if k != "head_dim"} == \
        {k: v for k, v in vars(smoke).items() if k != "head_dim"}
    assert serve.serve_config("bert4rec") == configs.get_arch("bert4rec").smoke()


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-15b", "deepseek-v2-lite-16b",
                                  "deepseek-v3-671b"])
def test_the_cli_serves_head_dims_the_kernel_takes_for_every_lm(arch):
    """GQA's smoke head dim 16 goes to 64; MLA's (16 + 8, 16) to the
    kernel's MLA pair (128 + 64, 128); nothing else moves."""
    smoke, served = configs.get_arch(arch).smoke(), serve.serve_config(arch)
    moved = {k for k in vars(smoke) if getattr(smoke, k) != getattr(served, k)}
    if smoke.attention == "mla":
        assert (served.qk_nope_dim, served.qk_rope_dim, served.v_head_dim) == (128, 64, 128)
        assert moved == {"qk_nope_dim", "qk_rope_dim", "v_head_dim"}
        pair = (served.qk_nope_dim + served.qk_rope_dim, served.v_head_dim)
    else:
        assert served.hd == 64 and moved == {"head_dim"}
        pair = (served.hd, served.hd)
    assert pair in ATTENTION_HEAD_DIM_PAIRS


@pytest.mark.parametrize("arch", serve.SERVED_ARCHS)
def test_cli_serves_on_the_cpu(arch):
    out = serve.main(["--arch", arch, "--device", "cpu"] + ARGS)
    cfg = serve.serve_config(arch)
    if isinstance(cfg, LMConfig):
        assert out.shape == (3, 5) and out.dtype == torch.int32
        assert bool(((out >= 0) & (out < cfg.vocab)).all())
    else:
        assert out.shape == (3, 10)
        assert bool(((out >= 0) & (out < cfg.n_items + 2)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", serve.SERVED_ARCHS)
def test_cli_serves_on_the_card(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = registry.launch_counts()["flash_attention"]
    out = serve.main(["--arch", arch] + ARGS)
    launched = registry.launch_counts()["flash_attention"] - before
    cfg = serve.serve_config(arch)
    if isinstance(cfg, LMConfig):
        assert out.shape == (3, 5)
        assert bool(((out >= 0) & (out < cfg.vocab)).all())
        assert launched == cfg.n_layers    # one prefill through the kernel
    else:
        assert out.shape == (3, 10) and launched == 0
