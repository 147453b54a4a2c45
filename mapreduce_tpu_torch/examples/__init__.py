"""Example user programs of the job plane (port of ``mapreduce_tpu/
examples``): WordCount in the single-module form, with the device hooks
that run its fused map, shuffle and reduce on the port's engine, and
the naive in-memory oracle."""
