from .tools.cli import main

raise SystemExit(main())
