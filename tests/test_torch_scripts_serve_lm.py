"""examples/torch_serve_lm.py --arch against examples/serve_lm.py on the
CPU, for a configuration of every LM family: the twin prints the
reference's lines (its served-in seconds masked) when its model holds the
reference's weights.  Each script draws its own random weights (the two
frameworks draw different numbers from one seed), so here the twin's
``Transformer`` is built from the JAX package's ``init_params`` with the
reference's key (``params_from_jax``); the rest of the twin (the
ServeEngine, the requests, the printing) runs unchanged.  encdec's
engine has no encoder positions (``src_len`` 0) in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_scripts import load, main_lines  # noqa: E402
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402,E501
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = ["llama3-8b", "mamba2-130m", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
         "recurrentgemma-9b", "seamless-m4t-large-v2",
         "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_lm_lines_match(arch, monkeypatch):
    twin = load("examples/serve_lm.py", twin=True)

    def from_jax(cfg, device=None, generator=None):
        jcfg = jax_smoke_config(arch).replace(dtype=cfg.dtype)
        jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
        return params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                               device=device)

    monkeypatch.setattr(twin.T, "Transformer", from_jax)
    ref, got = main_lines("examples/serve_lm.py", ["--arch", arch])
    assert got == ref and ref[0] == 0
    lines = ref[1]
    assert lines[0].startswith("arch=") and " in *s on a 4-slot pool" in \
        lines[0]
    assert [line.split(":")[0] for line in lines[1:]] == [
        f"  req{r}" for r in range(6)]
