"""Experiment constants (reference: ``Utils/Const.java``).

Epoch geometry of the P300 guess-the-number experiment (Const.java:61-72).
"""

PRESTIMULUS_SAMPLES = 100  # Const.PREESTIMULUS_VALUES
POSTSTIMULUS_SAMPLES = 750  # Const.POSTSTIMULUS_VALUES

CHANNEL_NAMES = ("fz", "cz", "pz")

EEG_EXTENSION = ".eeg"
