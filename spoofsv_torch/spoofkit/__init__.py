"""Evaluation harness of the port: spoof-set synthesis (:mod:`.spoofgen`)."""
