"""Session writers shared by the port's tests: BrainVision recordings in
the binary formats ``tests/_synthetic.py`` does not write."""

import os

import numpy as np

CHANNELS = ("Fz", "Cz", "Pz", "Oz")


def write_coded_recording(directory, name, binary_format, n_markers, guessed, seed,
                          orientation="MULTIPLEXED", resolutions=(1.0, 0.5, 0.25, 1.0)):
    """A BrainVision triplet with INT_32 or IEEE_FLOAT_32 samples (the
    synthetic module writes INT_16 only); markers every 1,000 samples,
    stimulus numbers cycling 1..9, one marker past the end. Each channel
    carries a DC offset no larger than its noise, the class of the JAX
    package's own DC fixture: there the reference's float32 baseline mean
    stays within 1e-6 of the port's float64 one (at DC 17x the noise the
    two drift apart by ~6e-6, the reference's error; ROADMAP.md C)."""
    rng = np.random.RandomState(seed)
    n_samples = 200 + n_markers * 1000 + 900
    x = rng.randn(n_samples, len(CHANNELS)) * 40.0 + rng.randn(1, len(CHANNELS)) * 30.0
    dtype = {"IEEE_FLOAT_32": "<f4", "INT_32": "<i4"}[binary_format]
    data = x.astype(dtype)
    if orientation == "VECTORIZED":
        data = np.ascontiguousarray(data.T)
    with open(os.path.join(directory, name + ".eeg"), "wb") as f:
        f.write(data.tobytes())
    vhdr = ["Brain Vision Data Exchange Header File Version 1.0", "[Common Infos]",
            f"DataFile={name}.eeg", f"MarkerFile={name}.vmrk", "DataFormat=BINARY",
            f"DataOrientation={orientation}", f"NumberOfChannels={len(CHANNELS)}",
            "SamplingInterval=1000", "[Binary Infos]", f"BinaryFormat={binary_format}",
            "[Channel Infos]"]
    vhdr += [f"Ch{i + 1}={ch},,{res},uV" for i, (ch, res) in enumerate(zip(CHANNELS, resolutions))]
    with open(os.path.join(directory, name + ".vhdr"), "w") as f:
        f.write("\n".join(vhdr) + "\n")
    vmrk = ["Brain Vision Data Exchange Marker File, Version 1.0", "[Marker Infos]"]
    vmrk += [f"Mk{i + 1}=Stimulus,S  {i % 9 + 1},{200 + i * 1000},1,0" for i in range(n_markers)]
    vmrk.append(f"Mk{n_markers + 1}=Stimulus,S  2,{n_samples + 500},1,0")
    with open(os.path.join(directory, name + ".vmrk"), "w") as f:
        f.write("\n".join(vmrk) + "\n")
    return f"{name}.eeg {guessed}"
