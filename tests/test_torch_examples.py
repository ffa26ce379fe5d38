"""The port's concurrent-serving example, reduced, on the CPU: a long
MLA decode job and a short dense one under FIFO, SRTF and adaptive SRTF
(in a file of its own, so that it runs beside the serving tests)."""

from repro_torch.examples import concurrent_serving


def test_concurrent_serving_example_reduced_on_cpu(capsys):
    out = concurrent_serving.main(["--device", "cpu", "--reduced"])
    assert sorted(out) == ["fifo", "srtf", "srtf-adaptive"]
    assert all(m.stp > 0 and m.antt > 0 for m in out.values())
    out = capsys.readouterr().out
    assert "solo runtimes: long-job=" in out and "Expected: SRTF" in out
