"""The port's benches (each writes its own JSON; none writes the JAX
package's ``BENCH_table3.json``)."""
