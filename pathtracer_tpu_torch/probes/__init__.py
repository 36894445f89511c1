"""Hardware probes of the port: the op-rate probe (P2, `op_rate`) and the
leaf microbenchmark (P3, `leaf_bench`), the Hopper counterparts of the JAX
package's tools/vpu_peak_probe.py and tools/leaf_microbench.py."""
