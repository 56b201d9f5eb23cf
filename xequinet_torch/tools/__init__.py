"""Study tools of the port, run as ``python -m xequinet_torch.tools.<name>``.

``make_synthetic_dataset`` writes an XDB dataset labelled by an explicit
many-body PES computed in torch; ``convergence_study`` trains flagship
XPaiNN on it through ``run_train``, tests the result with ``run_test`` and
measures the NVE drift of the trained model; ``bf16_accuracy_study`` trains
one XPaiNN per compute-dtype mode and tests each; ``bwd_stream_floor``
times the first-order message backward's stream floor on the card beside
the backward itself; ``convert_lmdb_dataset`` turns a reference XequiNet
LMDB dataset into an XDB one on the host.  Ports of the JAX package's
``tools/`` files of the same names.
"""
