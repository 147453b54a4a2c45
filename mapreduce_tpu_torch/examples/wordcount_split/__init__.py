"""WordCount, split-module form (port of ``mapreduce_tpu/examples/
wordcount_split``): one module per role, like the reference's
examples/WordCount/{taskfn,mapfn,partitionfn,reducefn,reducefn2,finalfn}.lua
— the form the server + worker-process topology names role by role:

  python -m mapreduce_tpu_torch.cli server http://HOST:PORT wc \\
      mapreduce_tpu_torch.examples.wordcount_split.taskfn \\
      mapreduce_tpu_torch.examples.wordcount_split.mapfn \\
      mapreduce_tpu_torch.examples.wordcount_split.partitionfn \\
      mapreduce_tpu_torch.examples.wordcount_split.reducefn \\
      mapreduce_tpu_torch.examples.wordcount_split.finalfn \\
      mapreduce_tpu_torch.examples.wordcount_split.reducefn \\
      http:HOST:PORT --init-args '{"files": [...]}'

Shared config lives in ``common.py``; every role module exposes ``init``
so whichever modules a task names, the config gets applied exactly once
(server.lua:452-456 dedups inits by identity)."""
