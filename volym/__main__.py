from volym.cli import main

raise SystemExit(main())
