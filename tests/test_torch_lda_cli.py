"""The port's `lda est` drop-in against the JAX package's, on the CPU:
the reference argument vector end to end on the golden flow and DNS
model.dat files, from the same (JAX) initial beta: the same files come
out, within the pipeline tests' tolerances; settings.txt parsed alike;
usage errors as the JAX CLI's."""

import os

import numpy as np
import pytest
import torch

import jax
from oni_ml_tpu.models import lda as jlda
from oni_ml_tpu.runner import lda_cli as jcli
from oni_ml_tpu_torch.io import formats
from oni_ml_tpu_torch.models import lda as tlda
from oni_ml_tpu_torch.runner import lda_cli

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "expected")
K = 20
SETTINGS = """var max iter 20
var convergence 1e-6
em max iter 30
em convergence 0
alpha estimate
"""


@pytest.fixture(scope="module", params=["flow", "dns"])
def runs(request, tmp_path_factory):
    """`lda est 2.5 20 settings.txt 20 <model.dat> random <out>` through
    both CLIs; the port's init_log_beta hands over the JAX draw (threefry
    cannot be replayed from a torch seed)."""
    root = tmp_path_factory.mktemp(f"lda_cli_{request.param}")
    settings = root / "settings.txt"
    settings.write_text(SETTINGS)
    model = os.path.join(GOLDEN, request.param, "model.dat")
    argv = ["est", "2.5", str(K), str(settings), "20", model, "random"]
    mp = pytest.MonkeyPatch()
    mp.setenv("ONI_ML_TPU_PLAN_CACHE", str(root / "plans.jsonl"))
    try:
        assert jcli.main(argv + [str(root / "jax")]) == 0

        def jax_init(generator, k, v, device="cpu"):
            draw = jlda.init_log_beta(jax.random.PRNGKey(0), k, v)
            return torch.as_tensor(np.array(draw), device=device)

        mp.setattr(tlda, "init_log_beta", jax_init)
        assert lda_cli.main(argv + [str(root / "port"), "--device",
                                    "cpu"]) == 0
    finally:
        mp.undo()
    return root / "port", root / "jax"


def test_same_files_within_tolerance(runs):
    """final.beta/.gamma/.other and likelihood.dat after 30 EM
    iterations (warm start off, lda-c's alpha loop), within the pipeline
    tests' bounds: likelihood rel 2e-5, gamma and alpha 2e-4, beta (as
    probabilities above 1e-12) 2e-3.  Measured (likelihood, gamma /
    alpha, beta): flow 2.8e-6, 4.4e-5 / 4.2e-5, 3.3e-4; dns 7.6e-6,
    2.9e-5 / 2.1e-5, 1.2e-4."""
    port, ref = runs
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "final.beta", "final.gamma", "final.other", "likelihood.dat"]
    ll_p = formats.read_likelihood(str(port / "likelihood.dat"))
    ll_r = formats.read_likelihood(str(ref / "likelihood.dat"))
    assert ll_p.shape == ll_r.shape == (30, 2)
    np.testing.assert_allclose(ll_p[:, 0], ll_r[:, 0], rtol=2e-5)
    np.testing.assert_allclose(
        np.exp(formats.read_beta(str(port / "final.beta"))),
        np.exp(formats.read_beta(str(ref / "final.beta"))),
        rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(formats.read_gamma(str(port / "final.gamma")),
                               formats.read_gamma(str(ref / "final.gamma")),
                               rtol=2e-4)
    o_p = formats.read_other(str(port / "final.other"))
    o_r = formats.read_other(str(ref / "final.other"))
    assert (o_p["num_topics"], o_p["num_terms"]) == (o_r["num_topics"],
                                                     o_r["num_terms"]) != (0, 0)
    np.testing.assert_allclose(o_p["alpha"], o_r["alpha"], rtol=2e-4)


def test_settings_parse_like_the_reference(tmp_path):
    path = tmp_path / "settings.txt"
    path.write_text("# lda-c settings\nVAR MAX ITER -1\nvar convergence 1e-5"
                    "\nem max iter 50.0\nem convergence 2e-4\nalpha fixed\n"
                    "em\nunknown key 3\n\n")
    assert lda_cli.read_settings(str(path)) == jcli.read_settings(str(path))
    cfg = lda_cli.config_from_settings(str(path), 1.5, 7)
    ref = jcli.config_from_settings(str(path), 1.5, 7)
    for name in ("num_topics", "alpha_init", "estimate_alpha",
                 "alpha_max_iters", "em_max_iters", "em_tol",
                 "var_max_iters", "var_tol", "warm_start_gamma"):
        assert getattr(cfg, name) == getattr(ref, name), name
    assert (cfg.var_max_iters, cfg.estimate_alpha) == (10_000, False)


@pytest.mark.parametrize("argv,rc", [
    (["--help"], 0),
    ([], 2),
    (["inf", "2.5", "20", "s.txt", "20", "m.dat", "random", "out"], 2),
    (["est", "2.5", "20", "s.txt", "20", "m.dat", "seeded", "out"], 2),
    (["est", "2.5", "20", "s.txt", "20", "m.dat", "random"], 2),
])
def test_usage_errors_match_reference(argv, rc, capsys):
    assert lda_cli.main(argv) == jcli.main(argv) == rc
    out = capsys.readouterr()
    assert "usage" in out.out + out.err or "random" in out.err


def test_unknown_device_is_a_usage_error(capsys):
    argv = ["est", "2.5", "20", "s.txt", "20", "m.dat", "random", "out"]
    assert lda_cli.main(argv + ["--device", "tpu"]) == 2
    assert "usage" in capsys.readouterr().err
