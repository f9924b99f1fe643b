"""Entries into the program, one file each: a configuration names its own
under ``"entry"``. An entry builds the deployment from the plaintext tables
and runs one round of the closed loop at a time, returning the round's
:class:`~chipbench.harness.record.Answer` s; ``start_block()`` comes before
each block of rounds (the warm one too) and ``close()`` after the window."""
