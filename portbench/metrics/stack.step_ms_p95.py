"""stack.step_ms_p95: step_ms_p95's reading, per layer, in the cells whose
95th percentile is too unsteady from run to run to bear a bound: the
stacked wrappers' host stalls set it there."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("step_ms_p95.py"), "metric_step_ms_p95").read
