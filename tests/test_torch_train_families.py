"""The port's training loss of every LM family against the JAX package's
``loss_and_metrics``, on the CPU: each family's smoke configuration in
float32 on identical weights (``params_from_jax``) and the same batch of
the data pipeline (a copy in both packages: vlm with its patch prefix,
encdec with its frames); loss, xent and aux (the MoE load balance)
within 1e-5.  Their train steps are held in
test_torch_train_{moe,hybrid,encdec_vlm}.py, the dense and ssm families'
in test_torch_train.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from _torch_train import batches, configs, jax_batch, loop  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = ["llama3-8b", "mamba2-130m", "qwen3-moe-30b-a3b", "deepseek-v3-671b",
         "recurrentgemma-9b", "seamless-m4t-large-v2",
         "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_matches_jax(arch):
    jcfg, cfg = configs(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    b = batches(cfg, 1)[0]
    _, want = JT.loss_and_metrics(jparams, jax_batch(b), jcfg)
    with torch.no_grad():
        _, got = model.loss_and_metrics(loop.to_device(b, "cpu"))
    for k in ("loss", "xent", "aux"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                              abs=1e-7), k
