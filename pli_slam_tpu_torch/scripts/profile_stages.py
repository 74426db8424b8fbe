"""Per-stage wall times of the visual path, each stage synchronised on the
device: the stage pass of `pli_slam_tpu_torch.utils.profile` (pass 3).

  python3 -m pli_slam_tpu_torch.scripts.profile_stages   (needs a GPU)
"""

from __future__ import annotations

import sys

from pli_slam_tpu_torch.utils import profile


def main(argv=None) -> int:
    return profile.main(["--stages", *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
