"""PyTorch/CUDA port of the EEG analysis framework.

The batch P300 pipeline (``info_file=…&fe=dwt-8-fused&train_clf=logreg``)
runs end to end on an NVIDIA H100: BrainVision triplets are parsed on
the host, each recording's raw int16 stream is staged to the card once,
one hand-written CUDA kernel (``csrc/ingest_features.cu``) turns samples
at marker positions into L2-normalized Daubechies features, and the
linear classifiers train with Spark-MLlib SGD semantics.

Subpackages mirror the JAX package ``eeg_dataanalysispackage_tpu`` module
for module, so each file has an obvious twin. This package imports
neither JAX nor any module of the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no CUDA available they raise.
"""

__version__ = "0.1.0"
