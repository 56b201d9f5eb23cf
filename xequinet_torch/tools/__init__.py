"""Study tools of the port, run as ``python -m xequinet_torch.tools.<name>``.

``make_synthetic_dataset`` writes an XDB dataset labelled by an explicit
many-body PES computed in torch; ``convergence_study`` trains flagship
XPaiNN on it through ``run_train``, tests the result with ``run_test`` and
measures the NVE drift of the trained model; ``bwd_stream_floor`` times the
first-order message backward's stream floor on the card beside the
backward itself.  Ports of the JAX package's
``tools/make_synthetic_dataset.py``, ``tools/convergence_study.py`` and
``tools/bwd_stream_floor.py``.
"""
