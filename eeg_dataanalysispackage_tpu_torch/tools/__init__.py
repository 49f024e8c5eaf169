"""The plan service's operator tools, runnable where the port runs.

Each is a module with a ``main(argv)`` and runs as
``python -m eeg_dataanalysispackage_tpu_torch.tools.<name>``; importing
one runs nothing. They read the port's journal, lease and placement
files and its run reports, and print what the JAX package's
``tools/`` scripts print on the same inputs:

- :mod:`.obs_report`: ``show`` and ``diff`` of run and crash reports;
- :mod:`.plan_admin`: ``list``, ``show``, ``stats``, ``tail``, ``fleet``
  and ``trace`` (one plan's cross-replica trace, stitched from the
  ``EEG_TPU_TRACE_DIR`` segment files);
- :mod:`.fleet_top`: one table of a replica fleet (``/metrics``,
  ``/stats``, the shared lease directory), or ``--snapshot`` JSON;
- :mod:`.chaos_run`: a query run clean and under a fault spec, diffed.
"""
