"""dispatch.ms_per_batch.720: `dispatch.ms_per_batch` in a cell whose
host-paced rate stands per layer (`driver.pairs_per_s`), where the
end-to-end metric is `kernel_ms_per_pair`: the stack, upload and replay
that pace the 720p clip."""

from benchmark import spec

read = spec.load_reader("dispatch.ms_per_batch")
