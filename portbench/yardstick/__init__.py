"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move it: kernel work from call shapes, model FLOPs, the
card's peaks, and the comparisons that decide ``correct``."""
