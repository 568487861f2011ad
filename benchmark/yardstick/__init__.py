"""What the benchmark measures with: generators, trace arithmetic, counts,
peaks and the comparison. Frozen: later changes to the program do not
edit these files."""
