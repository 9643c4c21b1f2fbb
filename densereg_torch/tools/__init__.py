"""The repository's tools on the port, each a module with ``main(argv=None)
-> int`` that runs as ``python -m densereg_torch.tools.<name>``:

- ``compare_results``: two reference-format result dumps against each
  other (numpy; the counterpart of ``tools/compare_results.py``);
- ``trace_summary``: a ``torch.profiler`` Chrome trace summed by name, the
  port's kernels named by their ids (``tools/trace_summary.py`` reads
  XLA's traces);
- ``serve_probe``: a load test of the serving daemon (``serve.Server``),
  running or self-hosted (``tools/serve_probe.py``);
- ``latency_probe``: the serving program's latency across batch sizes,
  and ``build_program``, the program it times (``tools/latency_probe.py``,
  ``bench._build``).

Importing a module touches no card; the probes run on ``--device`` (the
card by default) and fail where it is missing.
"""
