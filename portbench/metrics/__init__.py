"""One reader per metric: ``<name>.py`` defines ``read(reading)``, which
returns the metric's number, or None when the run holds nothing for it to
read (the harness then leaves the metric out of the result line)."""
