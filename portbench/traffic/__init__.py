"""Traffic kinds: each ``<kind>.py`` is the one generator of every mix
``<mix>.json`` beside it whose ``kind`` names it."""
