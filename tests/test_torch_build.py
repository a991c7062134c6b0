"""The kernel library's build: concurrent first calls build and load it once.

``--pipeline-depth`` runs buckets on worker threads, and on a checkout with
no ``build/`` their first kernel launches call ``_build.load()`` together.
Here ``nvcc`` is a stub script that counts its runs and writes its output
file, and ``ctypes.CDLL`` a stub that counts its loads, so the test runs on
the CPU.
"""

from __future__ import annotations

import re
import stat
import threading
import types

from vqattack_tpu_torch.ops import _build

N_THREADS = 8


def _stub_nvcc(tmp_path):
    """An ``nvcc`` that appends a line to ``runs.log``, waits a little (so
    that unserialised callers would overlap) and writes its ``-o`` file."""
    log = tmp_path / "runs.log"
    stub = tmp_path / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> "{log}"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        "sleep 0.2\n"
        'echo built > "$out"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    return stub, log


def _in_threads(fn):
    barrier = threading.Barrier(N_THREADS)
    results, errors = [], []

    def run():
        barrier.wait()
        try:
            results.append(fn())
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(N_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    return results


def test_concurrent_first_builds_run_nvcc_once(tmp_path, monkeypatch):
    stub, log = _stub_nvcc(tmp_path)
    lib_dir = tmp_path / "kernels"
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "library_path", lambda: lib_dir / "libvqattack_kernels.so")
    results = _in_threads(_build.build)
    # one build: a compile of each source, all started together, and one link
    runs = log.read_text().splitlines()
    assert len(runs) == len(_build.SOURCES) + 1, runs
    assert sum(" -shared " in f" {r} " for r in runs) == 1
    assert [p.name for p in lib_dir.iterdir()] == ["libvqattack_kernels.so"]
    assert set(results) == {lib_dir / "libvqattack_kernels.so"}
    # built: a later call runs nothing
    _build.build()
    assert len(log.read_text().splitlines()) == len(runs)


def test_concurrent_first_loads_build_and_load_once(tmp_path, monkeypatch):
    stub, log = _stub_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "libvqattack_kernels.so")
    monkeypatch.setattr(_build, "_LIB", None)
    loads = []

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(**{name: types.SimpleNamespace()
                                        for name in _build.SIGNATURES})

    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    libs = _in_threads(_build.load)
    assert loads == [str(tmp_path / "libvqattack_kernels.so")]
    assert len({id(lib) for lib in libs}) == 1
    assert len(log.read_text().splitlines()) == len(_build.SOURCES) + 1
    fn = getattr(libs[0], next(iter(_build.SIGNATURES)))
    assert fn.restype is _build.ctypes.c_int


def test_build_targets_sm90a_and_links_no_driver_library(tmp_path, monkeypatch):
    """K3-bf16 runs wgmma and setmaxnreg, which exist only for ``sm_90a``, so
    every compile and the link name that target; ptxas's report is asked
    for; and nothing links the driver library: the TMA map encoder
    (``cuTensorMapEncodeTiled``) is reached through the runtime's
    ``cudaGetDriverEntryPoint``, not called by its symbol."""
    stub, log = _stub_nvcc(tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "libvqattack_kernels.so")
    _build.build()
    runs = [r.split() for r in log.read_text().splitlines()]
    assert sorted(r[-1].rsplit("/", 1)[-1] for r in runs if "-c" in r) == sorted(_build.SOURCES)
    for args in runs:
        assert "arch=compute_90a,code=sm_90a" in args
        assert args[args.index("-Xptxas") + 1] == "-v"
        assert not [a for a in args if a.startswith("-l") or a.endswith("libcuda.so")], args
    src = (_build.CSRC / "flash_attention_bf16.cu").read_text()
    assert "cudaGetDriverEntryPoint" in src
    assert re.search(r"\bcuTensorMapEncodeTiled\s*\(", src) is None
    # the report of every source is kept for the smoke run's summary
    assert set(_build.PTXAS_REPORTS) >= set(_build.SOURCES)


def test_ptxas_summary_reads_registers_spills_and_serialization():
    """chip_smoke.py's summary of ptxas's report: one line a kernel with its
    template flags, registers, spills and a C7515 serialization."""
    import chip_smoke

    name = "_ZN56_GLOBAL__N__fd226401_23_flash_attention_bf16_cu_05493f2a19flash_bwd_dq_kernelILb1ELb0EEEvNS_6ParamsENS_4MapsE"
    report = "\n".join([
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name}",
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 16 barriers",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
        f"serialized due to non wgmma instructions in the function '{name}'",
    ])
    assert chip_smoke.ptxas_summary(report) == [
        "  ptxas flash_bwd_dq_kernel<1,0>: 168 registers at launch, spill stores 8 B, "
        "spill loads 12 B, wgmma serialized (C7515)"]
    assert "no report" in chip_smoke.ptxas_summary(None)[0]
