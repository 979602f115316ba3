"""The QAFeL round on a decoder architecture (``steps``)."""
