"""Check that chip_smoke.py fails, with its cause, when the sketch kernel
does not build or its launch returns an error, on one GPU.

    python3 dev/smoke_fault_check.py

Two cases, each in a process of its own, each running chip_smoke.main()
and passing only where it returns non-zero:

- build: csrc/ is copied into a temporary directory with a line that does
  not compile appended to sketch.cu, and cuda_build builds from there (into
  a temporary build directory), so phase 2 fails;
- launch: the sources build as they are, then the sketch's library is
  swapped for one whose launcher returns cudaErrorInvalidValue, so the
  wrapper raises at the first sketch launch (phase 3c); phases 3 and 3b are
  skipped to reach it quickly.

Run from the repository root; exits 1 if either case exits 0.
"""
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

CUDA_ERROR_INVALID_VALUE = 1


def run_case(case: str) -> int:
    import chip_smoke as c
    from pangraph_tpu_torch.ops import cuda_build as cb

    tmp = tempfile.mkdtemp()
    try:
        if case == "build":
            csrc = os.path.join(tmp, "csrc")
            shutil.copytree(cb.CSRC, csrc)
            with open(os.path.join(csrc, "sketch.cu"), "a") as fh:
                fh.write("\nthis line does not compile;\n")
            cb.CSRC, cb.BUILD_DIR = csrc, os.path.join(tmp, "build")
        else:
            class FailingLaunch:
                def sketch_launch(self, *args):
                    return CUDA_ERROR_INVALID_VALUE

            build = c.phase_build

            def build_then_fail():
                build()
                cb._LIBS["sketch.cu"] = FailingLaunch()

            c.phase_build = build_then_fail
            c.phase_kernels = c.phase_ckpt_kernels = c.phase_mbp = lambda torch: None
        return c.main()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("smoke_fault_check: needs a GPU", file=sys.stderr)
        return 1
    if argv:
        return run_case(argv[0])
    ok = True
    for case in ("build", "launch"):
        p = subprocess.run([sys.executable, __file__, case], capture_output=True, text=True)
        cause = [line for line in p.stderr.splitlines() if "chip_smoke: FAILED" in line]
        print(f"case={case} chip_smoke_exit={p.returncode} cause={cause[-1][:300] if cause else None!r}", flush=True)
        ok &= p.returncode != 0 and bool(cause)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
