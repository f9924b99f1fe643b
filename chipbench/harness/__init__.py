"""The benchmark's general machinery: it reads a cell from ``BENCHMARK.json``
and finds the cell's configuration, traffic mix, entry, reference, metric
readers and kernel costs by name, in files of their own."""
