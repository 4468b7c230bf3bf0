import sys

from tntblast_tpu.cli import main

sys.exit(main())
