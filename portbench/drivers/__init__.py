"""The loops that traffic mixes name: ``portbench/traffic/<mix>.json`` holds
``"driver": "<name>"`` and the parameters ``portbench/drivers/<name>.py``
reads."""
