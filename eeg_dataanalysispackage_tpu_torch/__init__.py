"""PyTorch/CUDA port of the EEG analysis framework.

The batch P300 pipeline (``info_file=…&fe=dwt-8-fused&train_clf=logreg``)
runs end to end on an NVIDIA H100: BrainVision triplets are parsed on
the host, each recording's raw int16 stream is staged to the card once,
one hand-written CUDA kernel (``csrc/ingest_features.cu``) turns samples
at marker positions into L2-normalized Daubechies features, and the
linear classifiers train with Spark-MLlib SGD semantics. The host
``fe=`` path (``fe=dwt-8``, ``-tpu``, ``-tpu-compact``, ``-pallas``) cuts
and baseline-corrects epochs on the host instead, and featurizes them
in float64 numpy, in PyTorch on the card, or (``-pallas``) with a third
kernel (``csrc/epoch_features.cu``). Recordings in float32 (or int32)
run on both paths. A saved model serves online (``serve=true``,
``serve.InferenceService``): each epoch window is one request,
micro-batched, and another kernel (``csrc/serve_mega.cu``) turns a
batch of int16 windows into margins.

Subpackages mirror the JAX package ``eeg_dataanalysispackage_tpu`` module
for module, so each file has an obvious twin. This package imports
neither JAX nor any module of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no CUDA available they raise.
"""

__version__ = "0.1.0"
