"""Experiment constants (reference: ``Utils/Const.java``).

Epoch geometry of the P300 guess-the-number experiment (Const.java:61-72).
"""

PRESTIMULUS_SAMPLES = 100  # Const.PREESTIMULUS_VALUES
POSTSTIMULUS_SAMPLES = 750  # Const.POSTSTIMULUS_VALUES
SAMPLING_FQ = 1000  # Hz
USED_CHANNELS = 3  # Fz, Cz, Pz
GUESSED_NUMBERS = 9

CHANNEL_NAMES = ("fz", "cz", "pz")

VHDR_EXTENSION = ".vhdr"
VMRK_EXTENSION = ".vmrk"
EEG_EXTENSION = ".eeg"
