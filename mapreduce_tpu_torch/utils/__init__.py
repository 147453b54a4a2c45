"""Host utilities of the job plane (port of ``mapreduce_tpu/utils``):
constants and status enums, the record line format, the k-way merge and
the host hashes.  Pure Python and numpy; nothing here touches a device."""
