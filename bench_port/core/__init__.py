"""The benchmark's yardstick: traffic, the program's assembly, the window
loops' shared parts, the reduction of traces, the peaks, the kernels'
least work and the comparison that decides ``correct``."""
