"""``repro_torch.launch.report``'s comm, autotune, shard and trace sections
against the JAX package's ``repro.launch.report``, in one process: given
the reference's constants (``hw=``), each section's text must be the
reference's, but for the note its heading adds naming those constants.
The trace section reads one Chrome trace written by the port's tracer.
Then ``main``: the sections not ported raise, and ``--device`` is
resolved as every entry point's is."""
import pytest
import torch

from repro.launch import mesh as jmesh
from repro.launch import report as jreport
from repro_torch.launch import hw
from repro_torch.launch import report
from repro_torch.obs import trace as ttrace

pytestmark = pytest.mark.tier1

#: the reference's constants (``repro/launch/mesh.py``) as a Hardware
#: record, as tests/test_torch_autotune.py passes them
REF_HW = hw.Hardware(
    name="the reference", link_alpha=jmesh.ICI_ALPHA,
    link_bw=jmesh.ICI_BW, pod_alpha=jmesh.DCI_ALPHA, pod_bw=jmesh.DCI_BW,
    hbm_bw=jmesh.HBM_BW, peak_flops_bf16=jmesh.PEAK_FLOPS_BF16)


def _without_note(text: str, hw_=REF_HW) -> str:
    note = report.constants_note(hw_)
    head, rest = text.split("\n", 1)
    assert head.endswith(note), head
    return head[:-len(note)] + "\n" + rest


def test_formatters_and_meshes_are_the_references():
    for x in (0, 3e-6, 2.5e-3, 0.42, 12.0):
        assert report.fmt_t(x) == jreport.fmt_t(x)
    for x in (12, 4.5e3, 7e6, 3.2e9, 1.5e12):
        assert report.fmt_b(x) == jreport.fmt_b(x)
    assert report.PRODUCTION_DP_AXES == jreport.PRODUCTION_DP_AXES


@pytest.mark.parametrize("section,args", [
    ("comm_section", ()), ("comm_section", (None, 1.0)),
    ("comm_section", (64e6,)), ("autotune_section", ()),
    ("shard_update_section", ())])
def test_section_equals_the_references_text(section, args):
    got = getattr(report, section)(*args, hw=REF_HW)
    assert _without_note(got) == getattr(jreport, section)(*args)


def test_sections_default_to_the_h100_and_name_it():
    text = report.comm_section()
    assert text.split("\n", 1)[0].endswith(report.constants_note(hw.H100))
    assert hw.H100.name in text.split("\n", 1)[0]
    # the card's constants give other times than the reference's
    assert _without_note(text, hw.H100) != jreport.comm_section()


def _trace(tmp_path):
    """A Chrome trace of two steps from the port's tracer (host clock)."""
    tracer = ttrace.Tracer()
    for step in range(2):
        tracer.begin_step()
        for name, cat in (("forward", "compute"), ("backward", "compute"),
                          ("rs[b1]", "comm"), ("rs[b0]", "comm"),
                          ("update", "compute")):
            ttrace.mark(tracer, name, "B", [torch.zeros(1)], cat=cat)
            ttrace.mark(tracer, name, "E", [torch.zeros(1)], cat=cat)
        tracer.end_step(step)
    with tracer.host_span("checkpoint_commit"):
        pass
    return ttrace.export_chrome(tracer, str(tmp_path / "trace.json"))


def test_trace_section_equals_the_references_text(tmp_path):
    path = _trace(tmp_path)
    got = report.trace_section(path)
    assert got == jreport.trace_section(path)
    assert "| 1 | rs[b0] | comm |" in got and "Host events" in got


@pytest.mark.parametrize("argv", [["--section", "roofline"],
                                  ["--section", "dryrun"],
                                  ["--compare", "x"]])
def test_main_refuses_the_dry_run_sections(argv):
    with pytest.raises(NotImplementedError, match="item 11"):
        report.main(argv + ["--device", "cpu"])


def test_main_prints_a_section_and_needs_a_card_by_default(tmp_path, capsys):
    path = _trace(tmp_path)
    text = report.main(["--section", "trace", "--trace-json", path,
                        "--device", "cpu"])
    assert capsys.readouterr().out.strip() == text.strip()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            report.main(["--section", "comm"])
