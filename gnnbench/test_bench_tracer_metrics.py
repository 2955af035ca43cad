"""The readers of the program tracer's totals (``stack_host_ms``,
``stage_pack_ms``, ``stack_stage_cpu_ms``, ``staged_mb``,
``sample_cpu_ms``, ``pull_busy_ms``, ``pull_cpu_ms``): nothing on a
window whose spans lack their name, as a program without the tracer's
sub-spans and loader totals gives, and the mean a step on a synthetic
window."""
import pytest

from gnnbench import harness

# the totals of a program whose tracer keeps the step's spans alone
STEP_ONLY = dict.fromkeys(
    ("wait_loaders", "stack_stage", "forward", "backward", "optimizer",
     "read_loss", "device_stack_stage", "device_forward", "device_backward",
     "device_optimizer"), 1.0)
# four steps: seconds summed over the window, staged_bytes a count
TOTALS = dict(STEP_ONLY, stack_host=2.0, stage_pack=1.2, stack_stage_cpu=2.8,
              staged_bytes=4 * 1_743_206_400, sample=44.0, sample_cpu=6.0,
              pull=3.0, pull_cpu=1.0)
WANT = {"stack_host_ms": 500.0, "stage_pack_ms": 300.0,
        "stack_stage_cpu_ms": 700.0, "staged_mb": 1743.2064,
        "sample_cpu_ms": 1500.0, "pull_busy_ms": 750.0, "pull_cpu_ms": 250.0}


def _window(spans, steps=4):
    return harness.Window(steps=steps, seconds=10.0, seeds=steps * 4000,
                          setup_s=1.0, spans=spans, sample_busy_s=44.0,
                          flops_per_step=0, peak=None)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_nothing_without_its_name(metric):
    assert harness.reader(metric)(_window(STEP_ONLY)) is None
    assert harness.reader(metric)(_window(TOTALS, steps=0)) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_the_mean_a_step(metric):
    assert harness.reader(metric)(_window(TOTALS)) == \
        pytest.approx(WANT[metric], rel=1e-12)
