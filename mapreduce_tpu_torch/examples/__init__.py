"""Example user programs of the job plane (port of ``mapreduce_tpu/
examples``): WordCount in the single-module form, with the device hooks
that run its fused map, shuffle and reduce on the port's engine; the
word-span index (``wordspan``, a 3-lane monoid on the same hooks); the
large-corpus glob (``wordcountbig``); the host-plane benchmark's
native-tokenizer word count (``wordcount_native``); the split-module
WordCount, the digits trainer and the naive in-memory oracle."""
