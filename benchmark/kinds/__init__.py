"""The code of the traffic kinds: a mix names its kind (``"kind"``), and
``benchmark/kinds/<kind>.py`` runs it (``run``)."""
