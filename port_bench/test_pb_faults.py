"""A run with the timed path broken underneath comes out not correct:
once for each fault a build cell can have. The runs skip the look for a
card and build on the host engine, at a tiny size; the check is the same."""
import os

import pytest

from pangraph_tpu_torch.graph.edits import Del, Edit, Ins, Sub
from pangraph_tpu_torch.ops.batch_align import BatchAligner
from port_bench import harness
from port_bench.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("pb")), 5, 4000)


def _run(root, workload="ecoli10-build"):
    with open(os.devnull, "w") as null:
        return harness.run_cell(workload, 2**31 + 17, 0.5, False, 0.0, root=root, device=None, out=null)


def _as_jobs(jobs):
    from pangraph_tpu_torch.ops.batch_align import AlignJob

    return [j if isinstance(j, AlignJob) else AlignJob(*j) for j in jobs]


def unchanged(jobs, edits):
    """A step that returns its state unchanged: no edit at all."""
    return [Edit() for _ in edits]


def half_left_out(jobs, edits):
    """Half the batch left out, its answers taken from the rest."""
    h = max(1, len(edits) // 2)
    return edits[:h] + [edits[i % h] for i in range(len(edits) - h)]


def altered(jobs, edits):
    """One answer altered where it is produced: a substitution's base."""
    out = list(edits)
    for k, e in enumerate(out):
        if e.subs:
            s = e.subs[0]
            out[k] = Edit(subs=[Sub(s.pos, "A" if s.alt != "A" else "C")] + e.subs[1:], dels=e.dels, inss=e.inss)
            break
    return out


def all_gaps(jobs, edits):
    """Valid but not aligned: every base of the longer jobs as a gap."""
    out = []
    for j, e in zip(_as_jobs(jobs), edits):
        if len(j.ref) > 200 and len(j.qry) > 200:
            e = Edit(subs=[], dels=[Del(0, len(j.ref))], inss=[Ins(0, bytes(j.qry).decode())])
        out.append(e)
    return out


def test_a_sound_run_is_correct(root):
    r = _run(root)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, all_gaps])
def test_a_fault_is_caught(root, monkeypatch, fault):
    orig = BatchAligner.align_many

    def broken(self, jobs):
        return fault(jobs, orig(self, jobs))

    monkeypatch.setattr(BatchAligner, "align_many", broken)
    r = _run(root)
    assert r["correct"] is False
