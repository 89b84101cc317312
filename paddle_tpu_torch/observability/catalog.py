"""Help text and label names of the labelled gauges the federation and
SLO planes publish, copied from ``paddle_tpu/observability/catalog.py``
(``LABELED_GAUGES``) so both declare them identically: a label mismatch
is a ValueError in whichever declares second."""
from __future__ import annotations

__all__ = ["LABELED_GAUGES"]

# name -> (help, labels)
LABELED_GAUGES = {
    "federation_target_up": (
        "1 while the member endpoint answers scrapes, 0 once it goes "
        "dark", ("instance",)),
    "federation_scrape_age_s": (
        "seconds since the member's last successful scrape "
        "(staleness)", ("instance",)),
    "slo_burn_rate": (
        "burn rate per objective and window (1.0 = budget consumed at "
        "exactly the sustainable pace)", ("objective", "window")),
    "slo_burning": (
        "1 while the objective burns on every configured window",
        ("objective",)),
}
