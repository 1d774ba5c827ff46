"""The benchmark's harness: it finds a cell's configuration, traffic mix and
metric readers by name (``manifest``), makes the fixture chain from the
seed (``chain``, over the frozen generator in ``chaingen``), drives the
port's prover service through its client (``cell``), records spans and the
device trace in traced runs (``spans``, ``devtrace``), and judges every
answer with the benchmark's own reference (``check``, over ``ref``)."""
