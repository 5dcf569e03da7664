"""Nothing the benchmark runs loads JAX or the JAX package: a tiny CPU run
of every generator in a process of its own, its modules checked by whole
top-level name after it (the port's name begins with the JAX package's)."""

import os
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run
    for name in ("jaxtyping", "mobgs_tpu_torch", "mobgs_tpu_torch.ops", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [n for n in run.forbidden_modules() if n.split(".")[0] not in run.FORBIDDEN]
    for name in ("jax", "jaxlib.xla_client", "mobgs_tpu", "mobgs_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in run.forbidden_modules()


def test_a_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{BENCH!r}, {ROOT!r}, {os.path.join(BENCH, 'tests')!r}]
        import torch
        import run, control
        from conftest import tiny
        from harness import train_mix, view_mix
        from mobgs_tpu_torch.ops import cuda_raster
        torch.cuda.synchronize = lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
        torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        cuda_raster.build_kernels = lambda *a, **k: {{}}
        cpu = torch.device("cpu")
        for gen, cell in ((train_mix, "seesaw.train"), (view_mix, "seesaw.view")):
            cfg, mix, lim = tiny(cell)
            res = gen.run(cfg, mix, lim, 5, 0.1, False, cpu, time.perf_counter())
            assert res["correct"], res["checks"]
        print("FORBIDDEN", run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
