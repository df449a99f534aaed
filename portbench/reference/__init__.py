"""The benchmark's plain reference: a frozen copy of the port's host layer
(reseek_tpu_torch at commit f533a72: encoder, Mu prefilter, per-pair
aligner, MKF route, LDDT, TS/P/E, output rows, and their native C++),
imports renamed to this package, with one implementation of each stage:
the native one (the port's numpy fallbacks and their switch left out).
It imports neither the port nor JAX; its native code builds with g++ at
first use into ``_build/`` here (build.py), and a failed build raises."""
