"""``python -m repro_torch.forecast`` runs the backtest CLI."""

import sys

from repro_torch.forecast.backtest import main

if __name__ == "__main__":
    sys.exit(main())
