"""Package-level checks of the port: the entry points refuse to fall back
to the CPU, the backend and config names resolve as documented, the
``cuda`` backends given CPU tensors run their kernels' plain versions and
launch nothing, and importing the port pulls in neither jax nor repro."""
import os
import subprocess
import sys

import pytest
import torch

import repro_torch as rt
from repro.core import SaifConfig as JConfig
from repro_torch.kernels import ops
from test_torch_saif import _one_torch_thread  # noqa: F401
from test_torch_saif import check_against_reference, ls_problem  # noqa: F401


def test_kernel_backends_on_cpu_run_plain_versions(ls_problem):
    """``cuda`` backends given CPU tensors run their kernels' plain
    versions through the wrappers; no kernel launches."""
    X, y, lm = ls_problem
    ops.reset_launch_counts()
    check_against_reference(
        X, y, 0.1 * lm, "least_squares", JConfig(inner_backend="jnp"),
        rt.SaifConfig(screen_backend="cuda", inner_backend="cuda"))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_entry_points_refuse_to_fall_back(ls_problem, monkeypatch):
    X, y, lm = ls_problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.saif(X, y, 0.5 * lm)
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.prepare_path(X, y)
    prep = rt.prepare_path(X, y, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        rt.solve_scalar(prep, 0.5 * lm)


def test_config_and_backend_names():
    assert rt.SaifConfig(unpen_idx=3).unpen_idx == 3
    with pytest.raises(ValueError):
        rt.SaifConfig(screen_rule="nope")
    from repro_torch.core.inner_backend import resolve_inner_backend
    from repro_torch.core.screen_backend import resolve_backend
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_backend("auto", cpu) == "torch"
    assert resolve_backend("auto", cuda) == "cuda"
    assert resolve_backend("torch", cuda) == "torch"
    with pytest.raises(ValueError):
        resolve_backend("jnp", cpu)
    # least squares under the crossover: the Gram engine (K6), as the
    # reference routes it on every backend
    assert resolve_inner_backend("auto", "least_squares", 100, 400,
                                 cuda) == "gram"
    assert resolve_inner_backend("auto", "least_squares", 100, 401,
                                 cuda) == "cuda"
    assert resolve_inner_backend("auto", "least_squares", 100, 400,
                                 cpu) == "gram"
    assert resolve_inner_backend("auto", "logistic", 100, 64, cuda) == "cuda"
    assert resolve_inner_backend("auto", "logistic", 100, 64, cpu) == "torch"
    # over the shared-memory gate on the card: raise, never the host loop
    for name in ("auto", "cuda"):
        with pytest.raises(ValueError, match="inner_backend='torch'"):
            resolve_inner_backend(name, "logistic", 10**5, 64, cuda)
    with pytest.raises(ValueError, match="shared-memory"):
        resolve_inner_backend("auto", "least_squares", 10**4, 50_000, cuda)
    assert resolve_inner_backend("torch", "logistic", 10**5, 64,
                                 cuda) == "torch"
    assert resolve_inner_backend("auto", "logistic", 10**5, 64,
                                 cpu) == "torch"
    with pytest.raises(ValueError):
        resolve_inner_backend("gram", "logistic", 100, 64, cpu)


def test_port_imports_no_jax_and_no_reference():
    """Importing every repro_torch module, the fleet's, CV's, selection's,
    the baselines', the kernels', the serving runtime's, the fault seam's,
    the checkpoints' and the group engine's (B-n3's wrapper and plain
    version) among them, and ``open_serving``, pulls in neither jax nor
    repro."""
    src = os.path.join(os.path.dirname(rt.__file__), os.pardir)
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "fleet = ['repro_torch.core.batch', 'repro_torch.convert',\n"
        "         'repro_torch.kernels.screen.screen',\n"
        "         'repro_torch.kernels.cm.cm', 'repro_torch.core.cv',\n"
        "         'repro_torch.core.select', 'repro_torch.kernels.gram.gram',\n"
        "         'repro_torch.kernels.gram.ref', 'repro_torch.core.dynamic',\n"
        "         'repro_torch.core.sequential', 'repro_torch.core.homotopy',\n"
        "         'repro_torch.kernels.cm.wide',\n"
        "         'repro_torch.core.batch_fast',\n"
        "         'repro_torch.runtime.fault', 'repro_torch.runtime.inject',\n"
        "         'repro_torch.ckpt.checkpoint', 'repro_torch.core.serving',\n"
        "         'repro_torch.core.group', 'repro_torch.kernels.group.group',\n"
        "         'repro_torch.kernels.group.ref']\n"
        "assert all(m in sys.modules for m in fleet), fleet\n"
        "from repro_torch import open_serving, ServingSession, Verdict\n"
        "from repro_torch.core.serving import open_serving as o2\n"
        "assert open_serving is o2 and Verdict._fields[0] == 'ok'\n"
        "from repro_torch.kernels import ops\n"
        "assert {'screen_fused_batch', 'ub_histogram_batch',\n"
        "        'cm_burst_batch', 'cm_epochs', 'gram_sweep',\n"
        "        'gram_sweep_batch', 'cm_sweep_wide', 'screen_fused_mixed',\n"
        "        'screen_fused_batch_mixed', 'group_bcd'} <= set(ops.KERNELS)\n"
        "assert ops.KERNELS['cm_sweep_wide'].launches == 0\n"
        "assert ops.KERNELS['group_bcd'].launches == 0\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
