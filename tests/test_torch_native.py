"""The JAX reference of the port's parity tests runs on its native library.

The JAX package builds ``csrc/libincagg_graph.so`` in place on first use
and, where loading it fails (several test processes building the same file
at once can leave one of them a half-written file), falls back to its numpy
builders and partitioner for the rest of the process, without an error.
The port always runs the native library, so a parity test would then
compare two different partitions.  :func:`use_native_jax_reference` makes
the JAX package load the library the port built atomically from the same
source with the same flags (``build/libincagg_graph.so``); the test files
that run the JAX loader, trainer or builders beside the port use it through
the module fixture :func:`jax_native_reference`.  It sets attributes of the
JAX package's module object at test time and restores them after; no file
of the JAX package changes.

The JAX package's own tests have no such fixture.  So, when this module is
imported — at collection, in every test process, before any test runs —
:func:`build_jax_native_libraries` makes sure that the JAX package's two
libraries (``csrc/libincagg_graph.so`` and ``csrc/libincagg_spill.so``)
exist and are no older than their sources: one process at a time, under a
lock on a file in ``build/``, each compiled with the JAX package's own
command under a private name and renamed into place.  The JAX package's
in-place build then finds an up-to-date library and never writes one, so
no process can load a half-written file.
"""

import fcntl
import os
import subprocess
import warnings

import numpy as np
import pytest

from incagg_gnn_tpu import history_spill as jax_spill
from incagg_gnn_tpu.graph import partition as J_part
from incagg_gnn_tpu.graph.datasets import make_sbm
from incagg_gnn_tpu.utils import native as jax_native
from incagg_gnn_tpu_torch.graph import csr as T_csr
from incagg_gnn_tpu_torch.graph import partition as T_part
from incagg_gnn_tpu_torch.utils import native as port_native


def build_jax_native_libraries() -> None:
    """Build the JAX package's native libraries where they are missing or
    older than their sources (see the module docstring); warn and leave
    things as they were if ``g++`` fails."""
    os.makedirs(port_native.BUILD_DIR, exist_ok=True)
    lock_path = os.path.join(port_native.BUILD_DIR, "jax_native.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        for src, so in ((jax_native._SRC, jax_native._SO),
                        (jax_spill._SRC, jax_spill._SO)):
            if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            # the JAX package's command (utils/native.py, history_spill.py)
            proc = subprocess.run(
                ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
                 src, "-o", tmp], capture_output=True, text=True, timeout=240)
            if proc.returncode != 0:
                warnings.warn(f"g++ could not build {so}: {proc.stderr[-2000:]}")
                if os.path.exists(tmp):
                    os.remove(tmp)
                continue
            os.replace(tmp, so)


build_jax_native_libraries()


def use_native_jax_reference(mp: pytest.MonkeyPatch) -> None:
    """If the JAX package has no native library loaded, point it at the
    port's build of the same source and load that; fail (never skip, never
    fall back to numpy) if it still cannot load.  ``mp`` undoes it."""
    if jax_native.get_native_lib() is not None:
        return
    port_native.native_lib()  # builds build/libincagg_graph.so atomically
    mp.setattr(jax_native, "_SO", port_native._SO)
    mp.setattr(jax_native, "_LIB", None)
    mp.setattr(jax_native, "_TRIED", False)
    if jax_native.get_native_lib() is None:
        pytest.fail(f"the JAX package cannot load its native graph library "
                    f"(nor {port_native._SO}); the parity tests compare "
                    f"against its native builders and partitioner only")


@pytest.fixture(scope="module", autouse=True)
def jax_native_reference():
    with pytest.MonkeyPatch.context() as mp:
        use_native_jax_reference(mp)
        yield


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_failed_load_is_replaced_by_the_port_build(monkeypatch):
    """Under a simulated failed load (``_LIB`` None, ``_TRIED`` set) the
    JAX partitioner takes its numpy fallback, which partitions differently
    from the port; the helper restores the native partition, equal to the
    port's, and the module state comes back afterwards."""
    data = make_sbm(num_nodes=400, num_classes=4, num_features=8, avg_degree=8.0,
                    seed=1)[0]
    adj = data.adj_t
    want = T_part.partition_graph(T_csr.CSRGraph(adj.rowptr, adj.col, adj.value), 4,
                                  seed=0)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    assert not _same(J_part.partition_graph(adj, 4, seed=0), want)
    saved = jax_native._SO
    with pytest.MonkeyPatch.context() as mp:
        use_native_jax_reference(mp)
        assert jax_native._SO == port_native._SO
        assert jax_native.get_native_lib() is not None
        assert _same(J_part.partition_graph(adj, 4, seed=0), want)
    assert jax_native._LIB is None and jax_native._TRIED and jax_native._SO == saved


def test_jax_native_libraries_are_built_and_current():
    """After the collection-time build, both JAX libraries are current, so
    the JAX package's ``_build`` writes nothing; calling the build again
    changes nothing."""
    libs = ((jax_native._SRC, jax_native._SO), (jax_spill._SRC, jax_spill._SO))
    for src, so in libs:
        assert os.path.getmtime(so) >= os.path.getmtime(src), so
    before = [os.stat(so).st_mtime_ns for _, so in libs]
    build_jax_native_libraries()
    assert [os.stat(so).st_mtime_ns for _, so in libs] == before
    assert jax_spill._load() is not None
